"""Precomputed per-quality probability tables.

Reference semantics: genotype_model.c:10-21 (fill_base_prob_table).
For q in [0, MAX_QUAL]:
    e     = min(10^(-q/10), 0.5)        sequencing error probability
    k     = e / (3 - 4e)
    ln_k, ln(0.5+k), ln(1+k)
All q-dependent terms in the genotype model are gathers into these tables,
so the device kernel never evaluates a transcendental per observation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.ref.constants import LOG10, MAX_QUAL


@dataclass(frozen=True)
class QualTables:
    e: np.ndarray
    k: np.ndarray
    ln_k: np.ndarray
    ln_k_half: np.ndarray
    ln_k_one: np.ndarray


def qual_tables(dtype=np.float64) -> QualTables:
    q = np.arange(MAX_QUAL + 1, dtype=np.float64)
    e = np.exp(-0.1 * q * LOG10)
    e = np.minimum(e, 0.5)
    k = e / (3.0 - 4.0 * e)
    return QualTables(
        e=e.astype(dtype),
        k=k.astype(dtype),
        ln_k=np.log(k).astype(dtype),
        ln_k_half=np.log(0.5 + k).astype(dtype),
        ln_k_one=np.log(1.0 + k).astype(dtype),
    )


# Selector codes for the non-informative count contributions
# (genotype_model.c:109-164). For observed base i (A,C,G,T) and genotype g:
#   2 -> n * ln(1+k)   (homozygous in base i)
#   1 -> n * ln(.5+k)  (heterozygous containing base i)
#   0 -> n * ln(k)     (genotype lacks base i)
# Genotype order: AA AC AG AT CC CG CT GG GT TT
NONINF_SEL = np.array(
    [
        # AA AC AG AT CC CG CT GG GT TT
        [2, 1, 1, 1, 0, 0, 0, 0, 0, 0],  # A observed
        [0, 1, 0, 0, 2, 1, 1, 0, 0, 0],  # C observed
        [0, 0, 1, 0, 0, 1, 0, 2, 1, 0],  # G observed
        [0, 0, 0, 1, 0, 0, 1, 0, 1, 2],  # T observed
    ],
    dtype=np.int32,
)


def ref_prior_matrix(ref_bias: float, dtype=np.float64) -> np.ndarray:
    """Prior log-likelihood per (ref_base 0..4, genotype 0..9).

    genotype_model.c:87-108: homozygous-ref genotype gets log(ref_bias);
    heterozygous genotypes containing ref get log((1+ref_bias)/2).
    ref base 0 (N) gets no prior.
    """
    lrb = np.log(ref_bias)
    lrb1 = np.log(0.5 * (1.0 + ref_bias))
    p = np.zeros((5, 10), dtype=np.float64)
    # ref = A
    p[1, 0] = lrb
    p[1, 1] = p[1, 2] = p[1, 3] = lrb1
    # ref = C
    p[2, 4] = lrb
    p[2, 1] = p[2, 5] = p[2, 6] = lrb1
    # ref = G
    p[3, 7] = lrb
    p[3, 2] = p[3, 5] = p[3, 8] = lrb1
    # ref = T
    p[4, 9] = lrb
    p[4, 3] = p[4, 6] = p[4, 8] = lrb1
    return p.astype(dtype)
