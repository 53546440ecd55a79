"""Work of K12 (`csrc/pileup_genotype.cu`, `pileup_genotype_kernel`): the
pileup of the used reads and the 10-genotype model at every covered
position, for one pass, from `inputs.pileup_input`.

Bytes, each counted once:
* in: 2 B a pileup base (its base and its quality), 16 B a used record
  (start, length, strand, mapping quality), 1 B a covered position's
  reference code;
* out, a covered position: what the caller reads back, genotype
  log-posteriors 10 x 8 B, the best genotype 4 B, its likelihood margin
  8 B and the off-maximum sum 8 B, and the eight per-category quality
  aggregates 8 x 4 B: 132 B.
Operations: ~940 FLOP a covered position (the model, a log or exp
counted as 40), in float64."""

KERNEL = "pileup_genotype_kernel"
OUT_BYTES = 10 * 8 + 4 + 8 + 8 + 8 * 4
FLOP_PER_POSITION = 940


def work(inp: dict) -> dict:
    return {
        "bytes": 2 * inp["bases"] + 16 * inp["records_used"]
        + inp["covered"] * (1 + OUT_BYTES),
        "flop": FLOP_PER_POSITION * inp["covered"],
        "flop_kind": "fp64",
    }
