"""Share of the replay's host seconds spent in the MSA/DP fallback, in %:
the completed reads' summed ``timer_dp`` over ``phase_times["replay"]``."""


def read(m):
    replay = m.phase_times["replay"]
    return 100.0 * m.timer_dp / replay if replay > 0 and m.timer_dp > 0 else None
