"""Gap tasks the walks phase enumerated per kbp completed: the corrector's
``stats["gaps"]`` over the window's input kbp.  A count of work."""


def read(m):
    return m.stats["gaps"] / (m.bases / 1e3) if m.bases else None
