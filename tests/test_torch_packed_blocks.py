"""Several small blocks in one fused call (`TorchCallEngine.call_blocks_soa`):
each block's result equals its own `call_block_soa`, array for array, on
synthetic blocks built to reach the edges of the packing: rows that start
before a block and run past its end, a deep block, blocks of one and of
two tiles, a last segment that ends l_cap + 1 positions before the chunk's
end, and a block whose quals mismatch and which goes to the column tier
alone. The plain kernels here; the `cuda` twin on the card."""

import numpy as np
import pytest
import torch

from bs_call_tpu_torch.config import CallerConfig
from bs_call_tpu_torch.ops.kernels.pileup_device import device_pileup_plain
from bs_call_tpu_torch.ops.postprocess import aggregate_pileup
from bs_call_tpu_torch.pipeline.engine import TorchCallEngine

CPU = torch.device("cpu")
# K3 leaves these fields unspecified on a row it flags `risk` (it skips the
# Fisher test there), and a segment's first row is flagged for its left
# neighbour: the host recomputes every field of a flagged row
ON_RISK_UNSPECIFIED = {"fs_hi", "fs_int", "flt", "mac1", "cg_code", "cond_cg"}


def make_block(rng, sz, n_rows, L, cfg, before=0, past=0):
    """A block of sz positions: n_rows reads of L bytes (lengths 30..L)
    starting in [-before, sz - L + past], its pileup and aggregate as the
    host would give them, and random reference codes: one entry of
    `call_blocks_soa`'s argument."""
    lens = rng.integers(min(30, L), L + 1, n_rows).astype(np.int32)
    starts = np.sort(rng.integers(-before, max(sz - L + past, -before) + 1,
                                  n_rows)).astype(np.int32)
    q = rng.choice([2, 12, 23, 30, 37, 40], size=(n_rows, L),
                   p=[0.03, 0.05, 0.1, 0.1, 0.62, 0.1])
    rd = ((rng.integers(0, 4, (n_rows, L)) | (q << 2))
          * (np.arange(L)[None, :] < lens[:, None])).astype(np.uint8)
    reads = {
        "rd": rd, "starts": starts,
        "ori": rng.integers(0, 2, n_rows).astype(np.int32),
        "strand": rng.integers(0, 3, n_rows).astype(np.int32),
        "mapq": rng.integers(0, 61, n_rows).astype(np.int32),
        "lens": lens,
    }
    c2, qs, m2 = (t.numpy() for t in device_pileup_plain(
        *(torch.from_numpy(reads[k]) for k in
          ("rd", "starts", "ori", "strand", "mapq")), sz, cfg.min_qual))
    agg = aggregate_pileup(c2, qs, m2)
    ref = rng.integers(0, 5, sz).astype(np.int32)
    return (c2, qs, m2, ref, agg, (reads, 0))


def assert_same(got, want, name):
    assert got.keys() == want.keys(), name
    for k in want:
        if k != "dev_prep":
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{name} {k}")
    if "dev_prep" not in want:
        return
    g, w = got["dev_prep"], want["dev_prep"]
    assert g.keys() == w.keys(), name
    np.testing.assert_array_equal(g["risk"], w["risk"], err_msg=name)
    sure = ~w["risk"]
    for k in w:
        a, b = (g[k], w[k]) if k not in ON_RISK_UNSPECIFIED else (
            g[k][sure], w[k][sure])
        np.testing.assert_array_equal(a, b, err_msg=f"{name} dev_prep {k}")


def packed_blocks(cfg, eng, seed):
    """Five blocks that fill one chunk: (name, block) in order, the last
    one sized so that its segment ends l_cap + 1 positions before n_pos."""
    rng = np.random.default_rng(seed)
    blocks = [
        ("one_tile", make_block(rng, 40, 30, 50, cfg, past=20)),
        ("two_tiles", make_block(rng, 200, 80, 50, cfg, before=25,
                                 past=30)),
        ("deep", make_block(rng, 100, 600, 70, cfg, before=40)),
        ("quals_mismatch", make_block(rng, 60, 60, 50, cfg)),
    ]
    agg = blocks[3][1][4]
    cov = np.nonzero(agg["n"] > 0)[0][:20]
    agg["quals"][cov, np.argmax(agg["counts"][cov], axis=1)] += 1
    width = 70
    l_cap = 128
    n_pos = eng._n_pos()
    sizes = [len(b[3]) for _n, b in blocks]
    offs = eng.pack_offsets([*sizes, 1], width)
    last = n_pos - l_cap - 1 - offs[-1]
    assert last > 128
    blocks.append(("last", make_block(rng, last, 300, 50, cfg, before=30,
                                      past=40)))
    sizes.append(last)
    offs = eng.pack_offsets(sizes, width)
    assert offs[-1] + last + l_cap + 1 == n_pos
    assert eng.pack_offsets([*sizes[:-1], last + 1], width) is None
    assert all(o % 128 == 0 for o in offs)
    return blocks


def check_pack(device, devices, seed):
    cfg = CallerConfig(batch_positions=2048)
    eng = TorchCallEngine(cfg, device, devices)
    blocks = packed_blocks(cfg, eng, seed)
    got = eng.call_blocks_soa([b for _n, b in blocks])
    assert eng.fused_chunks == 1
    assert eng.fused_blocks == len(blocks) - 1
    mism = np.count_nonzero(blocks[3][1][4]["n"])
    assert eng.tier_positions["quals_reroute"] == mism
    assert eng.tier_positions["column"] == mism
    for (name, b), soa in zip(blocks, got):
        lone = TorchCallEngine(cfg, device, devices)
        want = lone.call_block_soa(*b[:4], agg=b[4], reads=b[5])
        assert_same(soa, want, name)
        if name == "quals_mismatch":
            assert "dev_prep" not in soa
            assert lone.fused_chunks == 0
        else:
            assert soa["dev_prep"]["risk"][0], name
            assert lone.fused_chunks == lone.fused_blocks == 1
    return eng


@pytest.mark.parametrize("n_dev", [1, 2])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_packed_call_equals_each_blocks_own(n_dev, seed):
    """call_blocks_soa over five blocks is one fused chunk (K12 + K3 once)
    whose per-block results equal each block's own call; over two devices
    the packed chunk is cut into slabs of whole tiles as any chunk is."""
    eng = check_pack(CPU, [CPU] * n_dev, seed)
    assert eng.tier_positions["fused"] > 0


def test_blocks_that_do_not_fit_are_called_alone():
    """Blocks wider together than one chunk go through the fused tier one
    call each, with the same results."""
    cfg = CallerConfig(batch_positions=1024)
    eng = TorchCallEngine(cfg, CPU)
    rng = np.random.default_rng(11)
    blocks = [make_block(rng, 600, 60, 50, cfg) for _ in range(2)]
    assert eng.pack_offsets([600, 600], 50) is None
    got = eng.call_blocks_soa(blocks)
    assert eng.fused_chunks == eng.fused_blocks == 2
    for b, soa in zip(blocks, got):
        want = TorchCallEngine(cfg, CPU).call_block_soa(*b[:4], agg=b[4],
                                                        reads=b[5])
        assert_same(soa, want, "alone")


def test_pack_offsets():
    """Segments on whole tiles with l_cap + 1 positions after each; a lone
    block takes the whole chunk; reads wider than K12 takes fit nowhere."""
    eng = TorchCallEngine(CallerConfig(batch_positions=1024), CPU)
    n_pos = eng._n_pos()
    assert n_pos == 1088
    assert eng.pack_offsets([54, 54, 63], 50) == [0, 128, 256]
    assert eng.pack_offsets([64, 1], 50) == [0, 256]
    assert eng.pack_offsets([1, 1], 100) == [0, 256]
    assert eng.pack_offsets([n_pos], 50) == [0]
    assert eng.pack_offsets([n_pos + 1], 50) is None
    assert eng.pack_offsets([10], 4096) is None
    assert eng.pack_offsets([10] * 8, 50) == list(range(0, 1024, 128))
    assert eng.pack_offsets([10] * 9, 50) is None


@pytest.mark.cuda
def test_packed_call_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from bs_call_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    check_pack(dev, [dev], 7)
    check_pack(dev, [dev] * 2, 8)
