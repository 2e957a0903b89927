"""The port's copies of the JAX package's host modules stay copies.

Each copied module is read as text from both packages (nothing is
imported) and held byte-identical; the four copies with documented
differences may differ only in the top-level definitions listed here, so
a drift in either package fails a test rather than going unnoticed."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(REPO, "longreadselfcorrect_tpu")
PORT = os.path.join(REPO, "longreadselfcorrect_tpu_torch")

# the host modules behind the host-only subcommands
HOST_MODULES = (
    "core/preprocess.py", "core/kmer_correct.py", "core/pe_merge.py",
    "core/overlap_correct.py", "core/stdaln.py", "core/hybrid.py", "core/qc.py",
    "core/kmercheck.py", "graph/__init__.py", "graph/core.py", "graph/asqg.py",
    "graph/overlap.py", "graph/overlap_inexact.py", "graph/search.py",
    "graph/visitors.py", "graph/fmmerge.py", "graph/oview.py",
)
# the host modules pbcorrect needs, copied earlier
PBCORRECT_MODULES = (
    "core/__init__.py", "core/alphabet.py", "core/bcode.py", "core/correct.py",
    "core/extend.py", "core/itree.py", "core/threshold.py", "index/__init__.py",
    "index/build.py", "index/ssa.py", "index/store.py", "io/__init__.py", "io/fasta.py",
    "ops/__init__.py", "parallel/__init__.py",
)
# copies that differ, and the top-level definitions they differ in
DOCUMENTED = {
    # the --debugseed writers split out of search_seeds
    "core/seeds.py": {"open_seed_log", "search_seeds", "write_outcasts"},
    # the docstring of the numpy fill: the device fill is the port's route
    "core/overlapper.py": {"fill_cells_batched"},
    # the dev= route: the LF extractions of a DP fallback planned first and
    # run as one launch, the fills of a pileup as another, behind two gates
    "core/msa.py": {"FILL_DEVICE_MIN", "LF_DEVICE_MIN", "_lf_plan", "_max_length",
                    "_retrieve_strs", "build_multiple_alignment", "retrieve_matches",
                    "retrieve_str"},
    # the k-mer table's shift clamped for reads shorter than max_k
    "index/host.py": {"HostIndexSet"},
}


def read(root, rel):
    with open(os.path.join(root, rel), "rb") as f:
        return f.read()


@pytest.mark.parametrize("rel", HOST_MODULES + PBCORRECT_MODULES)
def test_copy_is_byte_identical(rel):
    assert read(PORT, rel) == read(JAX, rel), f"{rel} differs from the JAX package's"


def top_level(src: str) -> dict:
    """Source text of each top-level statement, keyed by the name it
    defines (the statement's own text for imports and the like)."""
    out = {}
    tree = ast.parse(src)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            key = node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            key = ",".join(ast.unparse(t) for t in targets)
        elif node is tree.body[0] and isinstance(node, ast.Expr) \
                and isinstance(node.value, ast.Constant):
            key = "<module docstring>"
        else:
            key = ast.unparse(node)
        out[key] = ast.get_source_segment(src, node)
    return out


@pytest.mark.parametrize("rel", sorted(DOCUMENTED))
def test_copy_differs_only_where_documented(rel):
    port, jax = (top_level(read(root, rel).decode()) for root in (PORT, JAX))
    differ = {k for k in set(port) | set(jax) if port.get(k) != jax.get(k)}
    assert differ == DOCUMENTED[rel]
    # the shared definitions come in the same order
    assert [k for k in port if k not in differ] == [k for k in jax if k not in differ]
