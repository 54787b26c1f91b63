"""``backward_ms.train``: mean stream ms of the program's
``train.backward`` span, ``torch.autograd.grad`` of a training step
with remat's recomputed forward inside it."""
import spans


def read(run, trace):
    return spans.mean_ms("train.backward")
