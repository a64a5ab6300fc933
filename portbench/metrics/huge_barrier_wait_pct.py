"""Share of the shared-memory huge sweep body's warp cycles spent at its
block barriers: each warp's SM cycles from its arrival to its release at
each hop's barriers, summed over the warps and blocks of every counted
launch, over the warps' SM cycles from their block's start to its end
(``sweep_kernels.huge_wait_cycles``). The mean over the warps: what the
block loses at the barriers, the waits of the warps that arrive early on the
last included. The program counts only while a torch.profiler records, one
launch of an entry in every ``sweep_kernels.HUGE_COUNT_EVERY``, and the
benchmark profiles only the traced slice, so the sums are a sample of the
slice's launches. None where no launch of the huge body was counted (another
body, or a program without the counter)."""


def read(summary):
    from bdd_tpu_torch.solver import sweep_kernels as sk

    counts = getattr(sk, "huge_wait_cycles", None)
    if counts is None:
        return None
    sums = counts().values()
    cycles = sum(c for _, c in sums)
    if cycles <= 0:
        return None
    return 100.0 * sum(w for w, _ in sums) / cycles
