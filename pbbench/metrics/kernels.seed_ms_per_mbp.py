"""Device ms of the seed phase's kernels per Mbp completed, from the
profiler's trace: ``kmer_table_full``, ``attributes``, ``scan_automaton``,
``estimate_best`` and ``remove_hitchhiking``."""

KERNELS = ("kmer_table_full", "attributes", "scan_automaton", "estimate_best",
           "remove_hitchhiking")


def read(m):
    if m.trace is None or not m.bases:
        return None
    s = m.trace.op_seconds(lambda n: any(f"{k}_kernel" in n for k in KERNELS))
    return 1e3 * s / m.mbp if s > 0 else None
