"""K1 launches in the device trace over the engine steps traced."""

from portbench.harness import readers


def read(run):
    return readers.kernel_launches_per_step(run, readers.K1_NAME)
