"""Host seconds of the walks phase per Mbp completed: ``phase_times["walks"]``
(enumerating the gap tasks, submitting them to the walk kernels and
collecting the results) over the window's input Mbp."""


def read(m):
    return m.phase_times["walks"] / m.mbp if m.bases else None
