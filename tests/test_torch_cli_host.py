"""The port's host-only subcommands against the JAX CLI.

chip_smoke.py's phase 16 (the PacBio hybrid pipeline, then assemble,
merge, oview, subgraph, grep, kmerfreq, kmercheck and all, on its seeded
corpus) runs here twice, through `python -m longreadselfcorrect_tpu.cli`
and through `python -m longreadselfcorrect_tpu_torch.cli`, each stage a
subprocess with PYTHONHASHSEED=0 and neither with native/hashorder.so.
Per subcommand the two runs give the same exit codes, byte-equal output
files (.gz files by content: a gzip header holds its write time; each
run's directory written as <dir>: `all` names its ASQG's input by it), the
same stdout and the same stderr with the timings masked; the JAX run's
digests are the constants phase 16 holds the card machine's run to; every
`--help` is byte-equal; and no stage of the port, `all` included, imports
JAX or the JAX package.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CLI = "longreadselfcorrect_tpu.cli"
PORT_CLI = "longreadselfcorrect_tpu_torch.cli"
# the JAX CLI's subcommands besides pbcorrect, which its own tests cover
SUBCOMMANDS = ("all", "preprocess", "index", "correct", "fmwalk", "filter", "merge",
               "overlap", "assemble", "asmlong", "oview", "subgraph", "grep", "pbhc",
               "kmerfreq", "kmercheck")
IMPORT_LINE = re.compile(r"^import time:\s+\S+ \|\s+\S+ \|\s*(\S+)\s*$")
TIMING = re.compile(r"\d+(\.\d+)?s\b|\(\d+(\.\d+)? sequences/s\)")


def foreign(module: str) -> bool:
    """A module of JAX or of the JAX package."""
    return (module in ("jax", "jaxlib", "longreadselfcorrect_tpu")
            or module.startswith(("jax.", "jaxlib.", "longreadselfcorrect_tpu.")))


def summary(stderr: str, d: str) -> list:
    """stderr without -X importtime's lines, the timings masked and the run
    directory written as <dir>."""
    return [TIMING.sub("<t>", line).replace(os.path.abspath(d), "<dir>")
            for line in stderr.splitlines() if not line.startswith("import time:")]


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Phase 16 through both CLIs at once (two chains of subprocesses):
    {"jax": (dir, genome, runs), "port": ...}; the port's stages list
    their imports on stderr (PYTHONPROFILEIMPORTTIME)."""
    assert not os.path.exists(os.path.join(REPO, "native", "hashorder.so")), \
        "phase 16's digests are taken without native/hashorder.so"
    base = tmp_path_factory.mktemp("host")
    out = {}

    def run(name, module, env):
        d = str(base / name)
        out[name] = (d,) + cs.run_host_pipeline(module, d, env)

    threads = [threading.Thread(target=run, args=("jax", JAX_CLI, {})),
               threading.Thread(target=run, args=("port", PORT_CLI,
                                                  {"PYTHONPROFILEIMPORTTIME": "1"}))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in ("jax", "port"):
        runs = out[name][2]
        failed = [(r[0], r[1], r[2], r[4][-3000:]) for r in runs if r[2] != 0]
        assert not failed and len(runs) == len(cs.host_stages()), (name, failed)
    yield out
    shutil.rmtree(base, ignore_errors=True)


@pytest.mark.parametrize("sub", SUBCOMMANDS)
def test_subcommand_matches_jax_cli(pipelines, sub):
    (jd, _, jruns), (pd, _, pruns) = pipelines["jax"], pipelines["port"]
    stages = [(i, s) for i, s in enumerate(cs.host_stages()) if s[0] == sub]
    assert stages
    for i, (_, _, _, outputs) in stages:
        jlabel, jargv, jrc, jout, jerr = jruns[i][:5]
        plabel, pargv, prc, pout, perr = pruns[i][:5]
        assert (plabel, pargv, prc) == (jlabel, jargv, jrc) and prc == 0
        assert pout == jout, plabel
        assert summary(perr, pd) == summary(jerr, jd), plabel
        for name in outputs:
            if name != cs.STDOUT:
                assert cs.output_bytes(pd, name) == cs.output_bytes(jd, name), (plabel, name)


def test_phase16_digests_are_the_jax_clis(pipelines):
    """The constants chip_smoke.py holds the card machine's phase 16 to
    are the JAX CLI's digests on the same corpus (and the port's)."""
    for name in ("jax", "port"):
        d, genome, runs = pipelines[name]
        got = {label: dig for label, *_, dig in runs}
        assert got == cs.HOST_DIGESTS, name
        res = cs.host_checks(genome, d)
        assert res["pieces"] > 0 and 2 * res["pieces_in_genome"] >= res["pieces"], res
        assert res["longest_in_genome"], res
        assert res["longest"] >= cs.HOST_ASM_SHARE * cs.HOST_GENOME_LEN, res


def test_port_stages_import_no_jax(pipelines):
    """Every stage of the port's run, `all` (which calls the CLI's main for
    each of its stages) included, imports nothing of JAX or of the JAX
    package: -X importtime lists each module a process imports."""
    runs = pipelines["port"][2]
    for label, argv, rc, out, err, *_ in runs:
        mods = [m.group(1) for m in map(IMPORT_LINE.match, err.splitlines()) if m]
        assert "longreadselfcorrect_tpu_torch" in mods, label
        assert not [m for m in mods if foreign(m)], label
    all_mods = next(r[4] for r in runs if r[0].endswith(" all"))
    for m in ("core.preprocess", "core.overlap_correct", "core.pe_merge", "core.qc",
              "graph.overlap", "graph.visitors"):
        assert f"longreadselfcorrect_tpu_torch.{m}" in all_mods


HELP = r"""
import contextlib, importlib, io, json, sys
cli = importlib.import_module(sys.argv[1])
out = {}
for sub in sys.argv[2:]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            cli.main([sub, "--help"])
        except SystemExit:
            pass
    out[sub] = buf.getvalue()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def helps():
    env = {**os.environ, "PYTHONHASHSEED": "0", "COLUMNS": "80"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = {}
    for module in (JAX_CLI, PORT_CLI):
        p = subprocess.run([sys.executable, "-c", HELP, module, *SUBCOMMANDS], env=env,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode == 0, p.stderr[-2000:]
        out[module] = json.loads(p.stdout)
    return out


@pytest.mark.parametrize("sub", SUBCOMMANDS)
def test_help_matches_jax_cli(helps, sub):
    assert helps[PORT_CLI][sub].startswith(f"usage: lrsc {sub} ")
    assert helps[PORT_CLI][sub] == helps[JAX_CLI][sub]


def test_index_routes_write_the_same_files(tmp_path, monkeypatch):
    """`index` on native/fmbuild (compiled here into a temporary
    directory) writes the same .bwt.npz/.rbwt.npz/.lex/.rlex/.ssa/.rssa
    files as its numpy route and as the JAX CLI's numpy route."""
    import argparse

    from longreadselfcorrect_tpu import cli as jcli
    from longreadselfcorrect_tpu_torch import cli
    from longreadselfcorrect_tpu_torch.index import store

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build native/fmbuild")
    exe = str(tmp_path / "fmbuild")
    subprocess.run([gxx, "-O2", "-std=c++17", "-pthread", "-o", exe,
                    os.path.join(REPO, "native", "fmbuild.cpp")], check=True)
    cs.make_host_corpus(str(tmp_path))
    reads = str(tmp_path / "pb.fa")

    def args(prefix, pure):
        return argparse.Namespace(readsfile=reads, prefix=str(tmp_path / prefix),
                                  ref_format=False, pure_python=pure)

    monkeypatch.setattr(store, "fmbuild_path", lambda: exe)
    assert cli.cmd_index(args("fm", False)) == 0
    assert os.path.exists(tmp_path / "fm.bwtraw")        # the fmbuild route ran
    assert cli.cmd_index(args("py", True)) == 0
    assert jcli.cmd_index(args("jax", True)) == 0
    for suffix in cs.INDEX_FILES:
        fm = (tmp_path / ("fm" + suffix)).read_bytes()
        assert fm == (tmp_path / ("py" + suffix)).read_bytes(), suffix
        assert fm == (tmp_path / ("jax" + suffix)).read_bytes(), suffix
