"""The kernels' build (`bs_call_tpu_torch.ops.kernels._build`) with a
stand-in `nvcc` that records its command lines: one compile per source,
all started before any is waited on, then one link; a build keyed by the
sources is reused, an edit rebuilds, a failed compile raises with the
compiler's output. The real nvcc runs only on the card's machine."""

import json
import os
import stat
import sys

import pytest

from bs_call_tpu_torch.ops.kernels import _build

FAKE_NVCC = """#!{python}
import json, os, sys, time
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(json.dumps([time.time(), args]) + "\\n")
if "-c" in args and args[-1].endswith("bad.cu"):
    print("bad.cu(1): error: expected a declaration")
    sys.exit(2)
if "-c" in args:
    time.sleep(1.0)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("object" if "-c" in args else "library")
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text(f"// {name}\n")
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "build"))

    def calls():
        if not log.exists():
            return []
        return [json.loads(ln) for ln in log.read_text().splitlines()]

    return csrc, calls


def test_build_compiles_each_source_in_parallel_then_links(fake_tree):
    csrc, calls = fake_tree
    lib = _build.build()
    assert open(lib).read() == "library"
    assert os.path.basename(lib) == _build.LIB_NAME
    got = calls()
    compiles, links = got[:-1], got[-1:]
    assert sorted(os.path.basename(a[-1]) for _t, a in compiles) == [
        "a.cu", "b.cu", "c.cu"
    ]
    for _t, args in compiles:
        assert args[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
        assert "-c" in args and "-shared" not in args
    # every compile started before the first one (1 s each) finished
    starts = [t for t, _a in compiles]
    assert max(starts) - min(starts) < 1.0
    (_t, link), = links
    assert link[:len(_build.LINK_FLAGS)] == _build.LINK_FLAGS
    assert sum(a.endswith(".o") for a in link) == 3
    # the same sources reuse the build; an edit rebuilds
    assert _build.build() == lib and len(calls()) == 4
    (csrc / "b.cu").write_text("// b.cu, edited\n")
    assert _build.build() != lib and len(calls()) == 8


def test_build_failure_raises_with_compiler_output(fake_tree):
    csrc, _calls = fake_tree
    (csrc / "bad.cu").write_text("oops\n")
    with pytest.raises(RuntimeError, match="expected a declaration"):
        _build.build()
    built = [f for _r, _d, files in os.walk(_build.BUILD) for f in files]
    assert built == []
