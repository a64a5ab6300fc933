"""Share of the traced slice in which the device sat idle because the host
waited for it: the idle gaps (the slice less the union of kernel, copy and
fill intervals) that a ``bdd.sync`` span caused, summed, over the slice. A
sync caused the gap in progress as the span ends if that gap began after the
span began; a gap already open before the span (the host behind its
dispatch) is left out, so this is at most ``device_idle_pct``, and the
difference is the idle of dispatch. None where the slice holds no span of
the program (``bdd.*``)."""
import bisect


def idle_gaps(summary):
    """(start ns, end ns) of the slice's idle gaps, in order."""
    lo, hi = summary["window_ns"]
    gaps, end = [], lo
    for _, s, e in sorted(summary["device"], key=lambda d: d[1]) + [("", hi, hi)]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    return gaps


def read(summary):
    host = summary["host"]
    if not any(name.startswith("bdd.") for name, _, _ in host):
        return None
    gaps = idle_gaps(summary)
    starts = [g[0] for g in gaps]
    caused = set()
    for name, s, e in host:
        if name != "bdd.sync":
            continue
        i = bisect.bisect_right(starts, e) - 1  # the last gap begun by the span's end
        if i >= 0 and e < gaps[i][1] and gaps[i][0] >= s:
            caused.add(i)
    lo, hi = summary["window_ns"]
    return 100.0 * sum(gaps[i][1] - gaps[i][0] for i in caused) / (hi - lo)
