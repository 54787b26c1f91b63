"""``optimizer_ms.train``: mean stream ms of the program's
``train.optimizer`` span, AdamW's update and its application."""
import spans


def read(run, trace):
    return spans.mean_ms("train.optimizer")
