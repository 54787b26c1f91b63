"""``compress_ms.train``: mean stream ms of the program's
``train.compress`` span: the gradient flattened, the error-feedback
residual added, K1 + K4's ``flat_qdq``, the new residual, the tree
unflattened."""
import spans


def read(run, trace):
    return spans.mean_ms("train.compress")
