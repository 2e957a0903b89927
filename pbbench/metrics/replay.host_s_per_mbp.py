"""Host seconds of the replay per Mbp completed: ``phase_times["replay"]``
(the per-read workflow on the prefetched walks, its miss rounds, the
host-engine fallbacks and the MSA/DP fallback) over the window's input
Mbp."""


def read(m):
    return m.phase_times["replay"] / m.mbp if m.bases else None
