"""``forward_ms.train``: mean stream ms of the program's ``train.forward``
span, the loss closure of a training step (``steps.value_and_grad``)."""
import spans


def read(run, trace):
    return spans.mean_ms("train.forward")
