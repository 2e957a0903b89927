"""Device ms of the walk kernels per Mbp completed, from the profiler's
trace: ``walk_queue``, ``walk_steps`` and ``walk_prep``."""

KERNELS = ("walk_queue", "walk_steps", "walk_prep")


def read(m):
    if m.trace is None or not m.bases:
        return None
    s = m.trace.op_seconds(lambda n: any(f"{k}_kernel" in n for k in KERNELS))
    return 1e3 * s / m.mbp if s > 0 else None
