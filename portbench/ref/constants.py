"""Model constants shared by the whole framework.

Behavioral contract documented against the reference implementation
(heathsc/bs_call v2.1.7):
  - quality encoding/limits: bs_call: include/bs_call.h:27-41
  - genotype order + het mask: bs_call: src/init_param.c:16
  - strand/base category mapping: bs_call: src/call_genotypes.c:17-19
  - model defaults: bs_call: include/bs_call.h:14-18
"""

from __future__ import annotations

import math

import numpy as np

VERSION = "2.1.7"  # behavior-parity target version of the reference

# Quality handling (bs_call.h:27-41)
MAX_QUAL = 43  # base qualities are clamped to this on input
MIN_QUAL = 20  # default minimum base quality used for calling (-Q)
FLT_QUAL = 63  # sentinel quality marking trimmed/masked bases

# Defaults (bs_call.h:14-18)
DEFAULT_MAPQ_THRESH = 20
DEFAULT_MAX_TEMPLATE_LEN = 1000
DEFAULT_UNDER_CONVERSION = 0.01
DEFAULT_OVER_CONVERSION = 0.05
DEFAULT_REF_BIAS = 2.0

LOG10 = 2.30258509299404568402  # bs_call.h:36

LFACT_STORE_SIZE = 256

# The 10 diploid genotypes, in reference order (genotype_model.c:84-230)
GT_NAMES = ("AA", "AC", "AG", "AT", "CC", "CG", "CT", "GG", "GT", "TT")

# Which genotypes are heterozygous (init_param.c:16)
GT_HET = np.array(
    [False, True, True, True, False, True, True, False, True, False], dtype=bool
)

# Filter names, bit order (init_param.c:15, print_vcf.c:186-189)
FILTER_NAMES = ("q20", "qd2", "fs60", "mq40")

# Base codes used throughout: 0=N 1=A 2=C 3=G 4=T (read_reference.c:46-49)
BASE_CODES = "NACGT"

# Bisulfite strand of a read (bs_call.h:49)
NON_CONVERTED = 0
STRAND_C2T = 1
STRAND_G2A = 2

# Orientation (bs_call.h:51)
FORWARD = 0
REVERSE = 1

# Pileup category table: maps (bs_strand, base 0..3 ACGT) -> category 0..7
# Categories 0-3: A,C,G,T non-informative for methylation;
# categories 4-7: A,C,G,T informative (call_genotypes.c:17-19; the C table is
# 1-based, stored here 0-based).
BASE_TAB_ST = np.array(
    [
        [0, 1, 2, 3],  # NON_CONVERTED
        [0, 5, 2, 7],  # C2T: C and T observations carry methylation signal
        [4, 1, 6, 3],  # G2A: A and G observations carry methylation signal
    ],
    dtype=np.int32,
)

# Read filter reasons (bs_call.h:50); order matters for the JSON report.
FLT_NONE = 0
FLT_UNMAPPED = 1
FLT_QC = 2
FLT_SECONDARY = 3
FLT_MATE_UNMAPPED = 4
FLT_DUPLICATE = 5
FLT_NOPOS = 6
FLT_NOMATEPOS = 7
FLT_MISMATCH_CHR = 8
FLT_ORIENTATION = 9
FLT_INSERT_SIZE = 10
FLT_NOSEQ = 11
FLT_MAPQ = 12
FLT_NOT_CORRECTLY_ALIGNED = 13
FLT_PAIR_NOT_FOUND = 14  # "PairNotFound" pseudo-class (get_template_vector.c:244)

# Base-level filter classes (bs_call.h:48)
BASE_NONE = 0
BASE_TRIM = 1
BASE_CLIP = 2
BASE_OVERLAP = 3
BASE_LOWQUAL = 4

# Output file types (reference used bcftools-style FT_* flags, parse_args.c:86-102)
FT_UNKN = 0
FT_GZ = 1
FT_VCF = 2
FT_VCF_GZ = 3
FT_BCF = 4
FT_BCF_GZ = 5


def lfact_store(dtype=np.float64) -> np.ndarray:
    """Log-factorial memo table (stats_utils.c:14-21)."""
    out = np.zeros(LFACT_STORE_SIZE, dtype=dtype)
    l = 0.0
    for i in range(2, LFACT_STORE_SIZE):
        l += math.log(float(i))
        out[i] = l
    return out


def logp_table(dtype=np.float64) -> np.ndarray:
    """logp[i] = log(0.01*(i+1)) used by the methylation posterior grid
    (init_param.c:56)."""
    return np.log(0.01 * (np.arange(1, 101, dtype=np.float64))).astype(dtype)
