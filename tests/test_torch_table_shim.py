"""kmer_table_wire of csrc/kmer_table.cu, and plane_rows and
kmer_table_planes of csrc/planes.cu, compiled for the host, equal their
plain versions bit for bit; one case of each is also held to the JAX
package's function.

No card here: each source is compiled with g++ behind the CUDA shim of
tests/test_torch_cuda_shim.py, blocks one at a time (the wire kernel keeps
its lane list in a static shared array), and its C entries
are called through ctypes with CPU pointers, the arguments built by the
functions the wrappers launch with (ops/scan.py kmer_table_wire_args,
kmer_table_planes_args, plane_rows_args).  Every output is filled with 7
first, so an entry the kernel leaves unwritten shows.

The reads are tests/test_torch_kernel_shim.py's n_reads (N inside the
first ck symbols of many lanes, reads shorter than ck, lanes at and past a
read's end), abutting_reads (two full rows, each starting with ACGT),
and wide_reads: two exact 1100-symbol reads of the genome and two empty
ones, so that with blocks of 256 to 1024 lanes the first block has every
lane live past its start, a block boundary falls inside a read, the
block of the N lane (start level 1) also holds lanes that start at ck,
so that its list runs empty between the two, and the last blocks have
no live lane.  The wire kernel runs from the walk index's pyramid at ck
8 and 10 and without one (ck 0); the plane kernel at ck 8 and 10; max_k
below, at and above ck, and 150, far past the 64 symbols a block stages
beyond its lanes.
"""
import numpy as np
import pytest
import torch

from longreadselfcorrect_tpu_torch.core import alphabet as ab
from longreadselfcorrect_tpu_torch.ops import scan

from test_torch_cuda_shim import build_host
from test_torch_kernel_shim import pyramid_pair  # noqa: F401  (the corpus and walk indexes)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def wire_lib(tmp_path_factory):
    return build_host("kmer_table.cu", tmp_path_factory.mktemp("wire_shim"),
                      ("lrsc_kmer_table_wire",), one_block=True)


@pytest.fixture(scope="module")
def planes_lib(tmp_path_factory):
    return build_host("planes.cu", tmp_path_factory.mktemp("planes_shim"),
                      ("lrsc_plane_rows", "lrsc_kmer_table_planes"), one_block=True)


def wide_reads(genome):
    """int8 [4, 1100]: two exact reads of the genome (every k-mer occurs;
    the second starts with an N) and two empty ones; lengths int32 [4]."""
    L = 1100
    mat = np.full((4, L), ab.PAD_RANK, np.int8)
    mat[0] = ab.encode(genome[100 : 100 + L])
    mat[1] = ab.encode(genome[2500 : 2500 + L])
    mat[1, 0] = 0   # an N: in block 1 one lane starts at level 1, the rest at ck
    return torch.from_numpy(mat), torch.tensor([L, L, 0, 0], dtype=torch.int32)


def abutting_reads(genome):
    """int8 [2, 1100]: two exact reads of the genome, each the row's full
    length and starting with ACGT: no PAD ends a row, so each row's last
    lanes settle at the row's end, with row 1's clean symbols staged just
    past them."""
    L = 1100
    mat = np.stack([ab.encode(genome[100 : 100 + L]), ab.encode(genome[2500 : 2500 + L])])
    assert (mat[:, :16] >= 1).all() and (mat[:, :16] <= 4).all()
    return torch.from_numpy(mat.astype(np.int8)), torch.tensor([L, L], dtype=torch.int32)


def reads_of(c, which):
    if which == "n_reads":
        return c["reads"], c["lens"]
    return (wide_reads if which == "wide" else abutting_reads)(c["genome"])


def wire_call(lib, c, reads, lens, max_k, ck):
    R, L = reads.shape
    K = max_k + 1
    f16 = torch.full((K, R, L), 7, dtype=torch.int16)
    vbits = torch.full(((K + 7) // 8, R, L), 7, dtype=torch.uint8)
    assert lib.lrsc_kmer_table_wire(*scan.kmer_table_wire_args(
        c["td"], reads, lens, max_k, c["wx"][ck] if ck else None, f16, vbits,
        on_card=False), None) == 0
    return f16, vbits


@pytest.mark.parametrize("which,ck,max_k", [
    ("n_reads", 0, 20), ("n_reads", 8, 0), ("n_reads", 8, 5), ("n_reads", 8, 8),
    ("n_reads", 8, 20), ("n_reads", 10, 9), ("n_reads", 10, 24), ("wide", 0, 16),
    ("wide", 8, 30), ("wide", 10, 10), ("wide", 8, 150), ("abut", 0, 16), ("abut", 10, 12),
    ("abut", 10, 24)])
def test_kmer_table_wire_kernel_matches_plain(wire_lib, pyramid_pair, which, ck, max_k):
    c = pyramid_pair
    reads, lens = reads_of(c, which)
    f16, vbits = wire_call(wire_lib, c, reads, lens, max_k, ck)
    want_f, want_v = scan.kmer_table_wire_plain(c["td"], reads, lens, max_k)
    assert torch.equal(f16, want_f) and torch.equal(vbits, want_v)
    # the corpus reaches what it is for: the clip on row 1, lanes live past
    # the start level, blocks with every lane live and blocks with none
    full_f, full_v = scan.kmer_table_full_plain(c["td"], reads, lens, max_k)
    assert np.array_equal(scan.unpack_valid_bits(vbits.numpy(), max_k + 1), full_v.numpy())
    if max_k >= 1:
        assert int(full_f[1].max()) > 32767 and (f16[1] == 32767).any()
    if which == "wide":
        lanes = full_f.reshape(max_k + 1, -1)
        # lanes 0-1023: every lane live to max_k, or to the read's end
        assert (lanes[min(max_k, 1100 - 1023), :1024] > 0).all()
        assert (lanes[1:, 3 * 1024 :] == -1).all()   # from lane 3072: no live lane


def test_kmer_table_wire_kernel_matches_jax(wire_lib, pyramid_pair):
    """ck 8, max_k 20 on n_reads against the JAX kmer_table_wire."""
    from longreadselfcorrect_tpu.ops import scan as jscan
    import jax.numpy as jnp

    c = pyramid_pair
    reads, lens = c["reads"], c["lens"]
    f16, vbits = wire_call(wire_lib, c, reads, lens, 20, 8)
    jf, jv = jscan.kmer_table_wire(c["jd"], jnp.asarray(reads.numpy()),
                                   jnp.asarray(lens.numpy()), 20)
    assert np.array_equal(f16.numpy(), np.asarray(jf))
    assert np.array_equal(vbits.numpy(), np.asarray(jv))


@pytest.mark.parametrize("strand", ["rbwt", "bwt"])
def test_plane_rows_kernel_matches_plain(planes_lib, pyramid_pair, strand):
    from longreadselfcorrect_tpu.ops import scan as jscan

    fm = getattr(pyramid_pair["td"], strand)
    out = torch.full((fm.blocks.shape[0], scan.PLANE_ROW), 7, dtype=torch.int32)
    assert planes_lib.lrsc_plane_rows(*scan.plane_rows_args(fm.blocks, fm.ckpt, out,
                                                            on_card=False), None) == 0
    assert torch.equal(out, scan.build_plane_rows_plain(fm.blocks, fm.ckpt))
    if strand == "rbwt":
        jfm = getattr(pyramid_pair["jd"], strand)
        assert np.array_equal(out.numpy(), np.asarray(jscan._build_plane_rows(jfm.blocks,
                                                                              jfm.ckpt)))


def planes_call(lib, pix, wcache, reads, lens, max_k, ck):
    R, L = reads.shape
    K = max_k + 1
    freq = torch.full((K, R, L), 7, dtype=torch.int32)
    valid = torch.ones((K, R, L), dtype=torch.bool)
    assert lib.lrsc_kmer_table_planes(*scan.kmer_table_planes_args(
        pix, wcache, reads, lens, max_k, ck, freq, valid, on_card=False), None) == 0
    return freq, valid


@pytest.mark.parametrize("which,ck,max_k", [
    ("n_reads", 8, 8), ("n_reads", 8, 20), ("n_reads", 10, 10), ("n_reads", 10, 24),
    ("wide", 8, 30), ("wide", 10, 12), ("wide", 10, 150), ("abut", 10, 24)])
def test_kmer_table_planes_kernel_matches_plain(planes_lib, pyramid_pair, which, ck, max_k):
    c = pyramid_pair
    reads, lens = reads_of(c, which)
    pix = scan.build_planes(c["td"])
    wcache = c["wx"][ck].wcache
    freq, valid = planes_call(planes_lib, pix, wcache, reads, lens, max_k, ck)
    want_f, want_v = scan.kmer_table_planes_plain(pix, wcache, reads, lens, max_k, ck)
    assert torch.equal(freq, want_f) and torch.equal(valid, want_v)
    assert (freq[:ck] == -1).all() and not valid[:ck].any()
    if which == "n_reads" and max_k > ck:   # lanes live past ck, and the N lanes
        assert (want_f[max_k, 0] > 0).any()


def test_kmer_table_planes_kernel_matches_jax(planes_lib, pyramid_pair):
    """ck 8, max_k 14 on n_reads against the JAX kmer_table_planes (XLA's
    compile of the unrolled levels grows fast with depth)."""
    from longreadselfcorrect_tpu.ops import scan as jscan
    import jax.numpy as jnp

    c = pyramid_pair
    reads, lens = c["reads"], c["lens"]
    wcache = c["wx"][8].wcache
    freq, valid = planes_call(planes_lib, scan.build_planes(c["td"]), wcache, reads, lens,
                              14, 8)
    jf, jv = jscan.kmer_table_planes(jscan.build_planes(c["jd"]), jnp.asarray(wcache.numpy()),
                                     jnp.asarray(reads.numpy()), jnp.asarray(lens.numpy()),
                                     14, 8)
    assert np.array_equal(freq.numpy(), np.asarray(jf))
    assert np.array_equal(valid.numpy(), np.asarray(jv))
