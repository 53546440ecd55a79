"""The kernels' build (`bs_call_tpu_torch.ops.kernels._build`) with a
stand-in `nvcc` that records its command lines: one compile per source,
all started before any is waited on, then one link; a build keyed by the
sources is reused, an edit rebuilds, a failed compile raises with the
compiler's output. The real nvcc runs only on the card's machine."""

import importlib.util
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


def _phase_tool():
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "kernel_phases.py")
    spec = importlib.util.spec_from_file_location("kernel_phases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the kernel of K2's first design, one thread a position, as far as
# `kernel_phases.k2_variants` edits it: the tool times an earlier commit's
# source beside this checkout's
K2_ONE_THREAD = """
template <typename T>
__global__ void __launch_bounds__(kBlock)
    genotype_column_kernel(const int* __restrict__ counts,
                           const int* __restrict__ quals,
                           const int* __restrict__ ref, long long n,
                           const T* __restrict__ tab,
                           const T* __restrict__ prior, double l, double t,
                           T* __restrict__ gt_prob, int* __restrict__ max_gt,
                           T* __restrict__ margin, T* __restrict__ off_sum) {
  __shared__ T s_tab[kNQ * 4];
  __shared__ T s_prior[5 * kNG];
  load_tables(tab, prior, s_tab, s_prior);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T nc[8];
  int q[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    nc[c] = T(counts[i * 8 + c]);
    q[c] = clamp_int(quals[i * 8 + c], 0, kNQ - 1);
  }
  T ll[kNG];
  model(nc, q, clamp_int(ref[i], 0, 4), s_tab, s_prior, l, t, ll);
  finish(ll, i, gt_prob, max_gt, margin, off_sum);
}
"""

# the kernel of K12's first design, two threads a position, as far as
# `kernel_phases.k12_variants` edits it: the tool times an earlier
# commit's source beside this checkout's
K12_TWO_THREAD = """
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) pileup_genotype_kernel(
    const uint8_t* __restrict__ rd, const int* __restrict__ tiles, int L,
    int n_pos, int min_qual) {
  __shared__ int s_counts[16 * kStride];  // [ori*8 + cat][position]
  __shared__ int s_qsum[8 * kStride];     // [cat][position]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  for (int j = tid; j < 16 * kStride; j += kThreads) s_counts[j] = 0;
  for (int j = tid; j < 8 * kStride; j += kThreads) s_qsum[j] = 0;

  // ---- pileup: staged batches of the rows that meet the tile ----
  const int r0 = tiles[2 * blockIdx.x];
  const int r1 = tiles[2 * blockIdx.x + 1];
  const int per = kStageBytes / L;  // rows per batch
  const int n_batch = r1 > r0 ? (r1 - r0 + per - 1) / per : 0;
  for (int b = 0; b < n_batch; ++b) {
    __syncthreads();
  }

  // ---- the model, two threads a position ----
  const int p = tid >> 1;
}
"""


def _checkout_source(name):
    with open(os.path.join(_build.CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("kernel, source, cuts", [
    ("k12", "pileup_genotype.cu", ("pileup", "model", "launch")),
    ("k3", "emit.cu", ("no_fisher", "light", "launch")),
    ("k2", "genotype.cu", ("model", "finish", "launch")),
    pytest.param("k2", K2_ONE_THREAD, ("model", "finish", "launch"),
                 id="k2-one-thread"),
    pytest.param("k12", K12_TWO_THREAD, ("pileup", "model", "launch"),
                 id="k12-two-thread"),
])
def test_phase_cuts_apply_to_the_kernel_sources(kernel, source, cuts):
    """`tools/kernel_phases.py` times a kernel cut at its phase
    boundaries by editing lines of its source: on this checkout's source
    (and on K2's one-thread design, the parent it is timed against) every
    cut finds its line and changes the text, and the full variant is the
    source itself; for K12 the occupancy probe appended to each variant
    names the design's dynamic shared memory."""
    tool = _phase_tool()
    src = _checkout_source(source) if source.endswith(".cu") else source
    variants = getattr(tool, f"{kernel}_variants")(src)
    assert variants["full"] == src
    assert sorted(variants) == sorted(("full", *cuts))
    for name in cuts:
        assert variants[name] != src, name
    with pytest.raises(RuntimeError, match="matches"):
        getattr(tool, f"{kernel}_variants")("// no kernel here\n")
    if kernel == "k12":
        probe = tool.k12_occupancy(src)
        assert "kp_resident_ctas" in probe
        assert ("kDynSmem" in probe) == ("kDynSmem" in src)
