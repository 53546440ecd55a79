"""The port's output contract with `bs_call_tpu`, as code.

Exact mode: VCF bytes and JSON report bytes equal those of
`python -m bs_call_tpu.cli --device cpu` on the same input and flags
(the report's date line aside, which changes at midnight).

`--no-exact` (f32 model, no oracle rescue): the same records at the same
positions, with differences confined to GL's last printed digit and to
GQ (and to QUAL and the q20 filter, which follow GQ) — the slack that
`bs_call_tpu.cli` documents for its own `--no-exact`.
"""

from __future__ import annotations

import math


def strip_date(report: str) -> str:
    return "\n".join(
        line for line in report.splitlines()
        if not line.startswith('\t"date"')
    )


def _records(vcf: str):
    return [line.split("\t") for line in vcf.splitlines()
            if not line.startswith("#")]


def _gl_close(a: str, b: str) -> bool:
    """GL prints 6 significant digits; an f32 likelihood carries about
    7, so two f32 evaluations agree to 5 significant digits."""
    x, y = float(a), float(b)
    if x == y:
        return True
    scale = max(abs(x), abs(y))
    return abs(x - y) <= 10.0 ** (math.floor(math.log10(scale)) - 4)


def check_no_exact(want: str, got: str) -> int:
    """Raise ValueError unless `got` differs from `want` only where the
    `--no-exact` contract allows. Returns the number of records."""
    if [ln for ln in want.splitlines() if ln.startswith("#")] != [
        ln for ln in got.splitlines() if ln.startswith("#")
    ]:
        raise ValueError("headers differ")
    a, b = _records(want), _records(got)
    if len(a) != len(b):
        raise ValueError(f"{len(a)} records vs {len(b)}")
    for ra, rb in zip(a, b):
        where = f"{ra[0]}:{ra[1]}"
        keys = ra[8].split(":")
        if rb[8] != ra[8] or len(ra) != len(rb):
            raise ValueError(f"{where}: FORMAT {ra[8]} vs {rb[8]}")
        sa = dict(zip(keys, ra[9].split(":")))
        sb = dict(zip(keys, rb[9].split(":")))
        gq_moved = sa.get("GQ") != sb.get("GQ")
        follows_gq = {5, 6} if gq_moved else set()  # QUAL, FILTER
        for i, (fa, fb) in enumerate(zip(ra[:8], rb[:8])):
            if fa != fb and i not in follows_gq:
                raise ValueError(f"{where}: column {i} {fa!r} vs {fb!r}")
        for k in keys:
            va, vb = sa[k], sb[k]
            if va == vb or k == "GQ" or (k == "FT" and gq_moved):
                continue
            if k == "GL" and all(
                _gl_close(x, y)
                for x, y in zip(va.split(","), vb.split(","))
            ) and va.count(",") == vb.count(","):
                continue
            raise ValueError(f"{where}: {k} {va!r} vs {vb!r}")
    return len(a)
