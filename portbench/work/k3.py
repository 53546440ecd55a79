"""Work of K3 (`csrc/emit.cu`, `emit_fields_kernel`): the emit fields
(Fisher strand test, GQ, QD, FS, MQ, the filter bits, mac1, GL, the CG
code) of every covered position, for one pass, from
`inputs.pileup_input`.

Bytes a covered position, each counted once: in, the genotype
log-posteriors 10 x 8 B, the best genotype 4 B, the strand-resolved
counts 2 x 8 x 4 B, the quality aggregates 8 x 2 B and the squared
mapping-quality sum 8 B (172 B); out, the packed row of fields the
emitter reads, 50 B. The Fisher walks' operations depend on the data and
are few beside the bytes: the bound counts bytes only."""

KERNEL = "emit_fields_kernel"
IN_BYTES = 10 * 8 + 4 + 2 * 8 * 4 + 8 * 2 + 8
OUT_BYTES = 50


def work(inp: dict) -> dict:
    return {"bytes": inp["covered"] * (IN_BYTES + OUT_BYTES), "flop": 0,
            "flop_kind": "fp64"}
