"""Share of the L2 sweep body's block cycles that its blocks spent at the
column hop barriers: thread 0's SM cycles from its arrival to the end of its
spin, summed over the blocks of every counted launch, over their SM cycles
from start to end (``sweep_kernels.l2_wait_cycles``). The program counts
only while a torch.profiler records, and the benchmark profiles only the
traced slice, so the sums are the slice's. None where no launch of the L2
body was counted (another body, or a program without the counter)."""


def read(summary):
    from bdd_tpu_torch.solver import sweep_kernels as sk

    counts = getattr(sk, "l2_wait_cycles", None)
    if counts is None:
        return None
    sums = counts().values()
    cycles = sum(c for _, c in sums)
    if cycles <= 0:
        return None
    return 100.0 * sum(w for w, _ in sums) / cycles
