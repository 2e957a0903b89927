"""Host seconds of the seed phase per Mbp completed: ``phase_times["seed"]``
(launching the device seed scan of each batch and collecting its records)
over the window's input Mbp."""


def read(m):
    return m.phase_times["seed"] / m.mbp if m.bases else None
