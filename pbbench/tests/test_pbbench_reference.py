"""The frozen reference equals the port's host SelfCorrector, read for read,
on the TINY data set: the port on its own pack, the reference on the
tables it makes from fmbuild's raw BWT files."""
import numpy as np

from pbbench import cells, check, corpus
from pbbench.reference import tables
from pbbench.reference.correct import CorrectionParams as RefParams
from pbbench.reference.correct import SelfCorrector as RefCorrector
from longreadselfcorrect_tpu_torch.core.correct import CorrectionParams, SelfCorrector
from longreadselfcorrect_tpu_torch.index.pack import open_index


def test_reference_equals_port_host(tiny_root):
    cfg = cells.load(tiny_root, "tiny.small").config
    data = corpus.ensure(tiny_root, cfg)
    port = SelfCorrector(open_index(data.prefix, device=None)[0],
                         CorrectionParams(**cfg["pbcorrect"]))
    ref = RefCorrector(tables.load(data.ref_dir), RefParams(**cfg["pbcorrect"]))
    longest = np.argsort(-data.lengths)
    dp = fm = 0
    for i in list(longest[:4]) + list(range(6)):
        rid, seq = f"r{i}", data.read(i)
        got, want = port.process(rid, seq), ref.process(rid, seq)
        assert not check.differs(got, {k: getattr(want, k) for k in check.COMPARED}), rid
        dp += got.dp_num
        fm += got.fm_num
    # both the walks and the DP fallback ran
    assert dp > 0 and fm > 0
