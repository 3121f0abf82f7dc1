"""Device ms a train step that SGDM's update (optim.SGDM, the span
``hfl.train.optimizer``) launched, in the long-context cells."""
from hflbench.metrics import _program as p


def read(ctx):
    return p.optimizer_ms(ctx)
