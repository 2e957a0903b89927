"""The port's kmercheck (core/kmercheck.py): ground-truth k-mer
classification + distribution summaries, the cases of
tests/test_kmercheck.py, each result also held equal to the JAX module's
(reference: PacBio/KmerCheckProcess.cpp, Util/KmerDistribution.cpp)."""
from longreadselfcorrect_tpu.core import bcode as jbc
from longreadselfcorrect_tpu.core import kmercheck as jkc
from longreadselfcorrect_tpu_torch.core import bcode as bc
from longreadselfcorrect_tpu_torch.core import kmercheck as kc


def kd_state(kd):
    return {k: (dict(v) if isinstance(v, dict) else v) for k, v in vars(kd).items()}


def test_kd_attributes_quartiles():
    kds = []
    for mod in (kc, jkc):
        kd = mod.KmerDistribution()
        for v, n in ((2, 2), (5, 3), (6, 4), (7, 3), (30, 1)):
            for _ in range(n):
                kd.add(v)
        kd.compute_attributes()
        kds.append(kd)
    kd, jkd = kds
    assert kd_state(kd) == kd_state(jkd) and str(kd) == str(jkd)
    # cumulative: 2->2, 5->5, 6->9, 7->12, 30->13; quartile targets 3/6/9.
    # The reference writes a quartile at BOTH bins when the target lands on
    # a bin boundary (prev <= t <= curr twice); last write wins -> q3=7.
    assert (kd.q1, kd.q2, kd.q3) == (5, 6, 7)
    assert kd.mode == 6
    # iqr=2 -> whiskers [2, 10]: min=2, max=7 (30 is an outlier)
    assert (kd.min, kd.max) == (2, 7)
    assert str(kd) == "2 5 6 7 7"


def test_compare_lines_threshold_pick():
    lines = []
    for mod in (kc, jkc):
        crt = mod.KmerDistribution()
        err = mod.KmerDistribution()
        for v in (8, 9, 10, 11):
            crt.add(v)
        for v in (2, 2, 3, 3):
            err.add(v)
        lines.append((mod.compare_lines(30, 17, crt, err), crt.min))
    ((tline, vline), crt_min), jlines = lines
    assert (tline, vline) == jlines[0]
    # correct distribution entirely above the error one: value = crt.min
    assert vline == f"30 17 {crt_min}"
    assert tline.startswith("30 17 | ")


def scan_both(freq, seq, code):
    """scan_read of both packages on one block: {k: state} of the correct
    and the error distributions, equal between the two."""
    out = []
    for mod, bmod in ((kc, bc), (jkc, jbc)):
        crt, err = {}, {}
        mod.scan_read(lambda k, pos: freq, seq, [bmod.BCode(0, len(seq), code, False)],
                      5, 5, 1, crt, err)
        out.append(tuple({k: kd_state(v) for k, v in m.items()} for m in (crt, err)))
    assert out[0] == out[1]
    return out[0]


def test_scan_read_classifies_error_windows():
    # perfect alignment block: all-zero code -> every window validates
    seq = "ACGTACGGTTACGATCGATT"
    crt, err = scan_both(5, seq, "00" * len(seq))
    assert 5 in crt and 5 not in err
    assert crt[5]["total"] == len(seq) - 5 + 1

    # an insertion marked at base 10 (upper nibble = 1): windows that cross
    # it without the matching bookkeeping must classify as erroneous
    code = ["00"] * len(seq)
    code[10] = "10"
    crt2, err2 = scan_both(5, seq, "".join(code))
    assert 5 in err2 and err2[5]["total"] > 0
    assert crt2[5]["total"] + err2[5]["total"] == len(seq) - 5 + 1

    # freq 1 windows are skipped entirely (the read itself)
    crt3, err3 = scan_both(1, seq, "00" * len(seq))
    assert not crt3 and not err3
