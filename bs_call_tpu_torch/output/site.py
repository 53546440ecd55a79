"""Per-site VCF record assembly with the 2-position lookahead pipeline.

Behavioral contract: print_vcf.c:32-594. The emitter receives one call per
pileup position (in order) and emits records lagged by 2 positions so the
CpG status can consult the called genotypes of the neighbouring positions.
All lookup tables below are data (transcribed constants), and the quirks of
the reference are reproduced:

  - rf context copy stops at the first N and zero-fills (strncpy semantics,
    print_vcf.c:575);
  - block flush keeps a stale duplicate in the lookahead slot
    (flush_vcf_entries memmove of 4/6 elements, print_vcf.c:540-541);
  - GT integers follow gt_int[][] verbatim, including 0x48 pairs that decode
    to "1/3" under htslib's (v>>1)-1 rule for two-ALT sites;
  - GL for two-ALT sites omits the alt1/alt2 likelihood (print_vcf.c:337-341
    computes it into a dead variable).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from bs_call_tpu_torch.constants import FILTER_NAMES, GT_HET, LOG10, logp_table
from bs_call_tpu_torch.ops.oracle import _lfact

# ref_alt[gt][rfix] (print_vcf.c:34-45)
REF_ALT = [
    ["A", "", "A", "A", "A"],
    ["AC", "C", "A", "AC", "AC"],
    ["AG", "G", "AG", "A", "AG"],
    ["AT", "T", "AT", "AT", "A"],
    ["C", "C", "", "C", "C"],
    ["CG", "CG", "G", "C", "CG"],
    ["CT", "CT", "T", "CT", "C"],
    ["G", "G", "G", "", "G"],
    ["GT", "GT", "GT", "T", "G"],
    ["T", "T", "T", "T", ""],
]

# mutation class per (gt, rfix) (print_vcf.c:46-57); 12 = mut_no
MUT_NO = 12
MUT_TYPE = [
    [12, 12, 3, 6, 9],
    [12, 0, 3, 12, 12],
    [12, 1, 12, 6, 12],
    [12, 2, 12, 12, 9],
    [12, 0, 12, 7, 10],
    [12, 12, 4, 7, 12],
    [12, 12, 5, 12, 10],
    [12, 1, 4, 12, 11],
    [12, 12, 12, 8, 11],
    [12, 2, 5, 8, 12],
]

CS_STR = ["NA", "+", "-", "NA", "+", "+-", "+", "-", "-", "NA"]

# allele index pairs for GL ordering (print_vcf.c:60-71)
ALL_IDX = [
    [[1, 0], [0, 0], [1, 0], [1, 0], [1, 0]],
    [[1, 2], [2, 0], [1, 0], [1, 2], [1, 2]],
    [[1, 3], [3, 0], [1, 3], [1, 0], [1, 3]],
    [[1, 4], [4, 0], [1, 4], [1, 4], [1, 0]],
    [[2, 0], [2, 0], [0, 0], [2, 0], [2, 0]],
    [[2, 3], [2, 3], [3, 0], [2, 0], [2, 3]],
    [[2, 4], [2, 4], [4, 0], [2, 4], [2, 0]],
    [[3, 0], [3, 0], [3, 0], [0, 0], [3, 0]],
    [[3, 4], [3, 4], [3, 4], [4, 0], [3, 0]],
    [[4, 0], [4, 0], [4, 0], [4, 0], [0, 0]],
]

# raw GT int pairs (print_vcf.c:73-84); decoded (v>>1)-1 at output
GT_INT = [
    [0x44, 0x22, 0x44, 0x44, 0x44],
    [0x48, 0x24, 0x24, 0x48, 0x48],
    [0x48, 0x24, 0x48, 0x24, 0x48],
    [0x48, 0x24, 0x48, 0x48, 0x24],
    [0x44, 0x44, 0x22, 0x44, 0x44],
    [0x48, 0x48, 0x24, 0x24, 0x48],
    [0x48, 0x48, 0x24, 0x48, 0x24],
    [0x44, 0x44, 0x44, 0x22, 0x44],
    [0x48, 0x48, 0x48, 0x24, 0x24],
    [0x44, 0x44, 0x44, 0x44, 0x22],
]

# skip homozygous-reference flag (AA on ref A, TT on ref T) (print_vcf.c:85-96)
GT_FLAG = [
    [0, 1, 0, 0, 0],
    [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 1],
]

PBASE = "NACGT"
IUPAC = "NAMRWCSYGKT"
CFLAG = [0, 1, 0, 0, 1, 1, 1, 0, 0, 0]  # genotype contains C
GFLAG = [0, 0, 1, 0, 0, 1, 0, 1, 1, 0]  # genotype contains G

_LOGP = logp_table()


@dataclass
class SiteCall:
    """Per-position model result handed to the emitter (gt_meth analogue,
    bs_call.h:152-160)."""

    counts: np.ndarray       # [8] int
    quals: np.ndarray        # [8] int
    gt_prob: np.ndarray      # [10] float (log10)
    fisher_strand: float
    mq: int
    aq: int
    max_gt: int


@dataclass
class LagState:
    """`_print_vcf_entry`'s statics (print_vcf.c:32-527): the last emitted
    contig and position (dedup) and the last '+'-strand CpG and its filter
    (the CpG pair). One a run, shared by the scalar, the vector and the
    row engine's emitter, read and written on the emit worker alone."""

    old_ctg: object = None
    old_x: int = 0
    prev_cpg_x: int = 0
    prev_cpg_flt: bool = False


@dataclass
class VcfSite:
    """Assembled record, ready for a VCF/BCF writer."""

    rid: int
    pos: int                  # 1-based
    rs_id: str
    ref: str
    alts: List[str]
    qual: int                 # phred
    filters: List[str]        # ["PASS"] / ["fail"] / ["mac1"]
    cx_info: str
    gt_ints: List[int]        # raw bcf GT values
    ft: str
    dp: int
    mq: int
    gq: int
    qd: int
    gl: List[float]
    mc8: List[int]
    amq: List[int]
    cs: str
    cg: str
    cx_fmt: str
    fs: Optional[int]         # None when genotype is homozygous


def cpg_status(gt_store: List[int]) -> str:
    """CpG status automaton over called genotypes (print_vcf.c:227-266).
    gt_store holds 1-based genotype codes (0 = uncalled) for positions
    x-2 .. x+2; the site being assessed is gt_store[2]."""
    g = gt_store
    if (g[2] == 5 and g[3] == 8) or (g[2] == 8 and g[1] == 5):
        return "CG"
    if g[2] == 5:
        if g[3]:
            return "H" if GFLAG[g[3] - 1] else "N"
        return "?"
    if g[2] == 8:
        if g[1]:
            return "H" if CFLAG[g[1] - 1] else "N"
        return "?"
    if CFLAG[g[2] - 1]:
        if g[3]:
            return "H" if GFLAG[g[3] - 1] else "N"
        return "?"
    if GFLAG[g[2] - 1]:
        if g[1]:
            return "H" if CFLAG[g[1] - 1] else "N"
        return "."
    return "."


class SiteEmitter:
    """Stateful emitter reproducing print_vcf_entry / flush_vcf_entries /
    _print_vcf_entry. Emitted VcfSite objects are passed to the supplied
    writer callable; stats (if given) are updated exactly as the reference
    does inside _print_vcf_entry."""

    def __init__(self, cfg, table, write, stats=None, dbsnp=None):
        self.cfg = cfg
        self.table = table
        self.write = write
        self.stats = stats
        self.dbsnp = dbsnp          # DbSnpIndex or None
        self._dbsnp_ctg = None
        self.curr_ctg = None
        self.store_x = 0
        self.gt_store = [0] * 5
        self.gtm_store: List[Optional[SiteCall]] = [None] * 5
        self.rf_ctxt = [0] * 7
        self.lag = LagState()

    # ---- push/flush pipeline (print_vcf.c:536-594) ----

    def push(self, ctg, gtm: Optional[SiteCall], rf: np.ndarray, x: int,
             xstart: int, skip: bool):
        if self.curr_ctg is not ctg:
            self.curr_ctg = ctg
            if self.dbsnp is not None:
                self._dbsnp_ctg = self.dbsnp.load_contig(ctg.name)
        l = x - self.store_x
        if l < 5:
            self.gt_store = self.gt_store[l:] + [0] * l
            self.gtm_store = self.gtm_store[l:] + self.gtm_store[5 - l :]
        else:
            self.gt_store = [0] * 5
        assert x > self.store_x
        self.store_x = x
        self.gtm_store[4] = gtm
        off = x - xstart
        if off >= 4:
            src = rf[off - 4 : off + 3]
            ctxt = [0] * 7
            for i, v in enumerate(src):
                if v == 0:      # strncpy stops at NUL (N), zero-fills
                    break
                ctxt[i] = int(v)
            self.rf_ctxt = ctxt
        else:
            l2 = off
            ctxt = [0] * 7
            j = 4 - l2
            for i, v in enumerate(rf[: 3 + l2]):
                if v == 0:
                    break
                ctxt[j + i] = int(v)
            self.rf_ctxt = ctxt
        if skip or gtm is None:
            self.gt_store[4] = 0
        else:
            self.gt_store[4] = int(np.argmax(gtm.gt_prob)) + 1
        if self.gt_store[2]:
            self._emit(self.gtm_store[2], x - 2)

    def flush(self):
        """Emit the final 2 pending positions (print_vcf.c:536-546)."""
        if self.curr_ctg is not None and self.store_x:
            for i in range(2):
                self.gt_store = self.gt_store[1:] + [self.gt_store[4]]
                self.gtm_store = self.gtm_store[1:] + [self.gtm_store[4]]
                self.rf_ctxt = self.rf_ctxt[1:] + [self.rf_ctxt[6]]
                if self.gt_store[2]:
                    self._emit(self.gtm_store[2], self.store_x - 1 + i)
            self.store_x = 0

    # ---- record assembly (print_vcf.c:32-527) ----

    def _emit(self, gtm: SiteCall, x: int):
        cfg = self.cfg
        ctg = self.curr_ctg
        if x == 0:
            return
        lag = self.lag
        if lag.old_ctg is not ctg:
            lag.old_ctg = ctg
        elif x <= lag.old_x:
            return
        lag.old_x = x
        counts = gtm.counts
        dp1 = int(counts[:4].sum())
        d_inf = int(counts[4:].sum())
        dp = dp1 + d_inf
        if not dp:
            return
        rs_found = 0
        rs = ""
        if self._dbsnp_ctg is not None:
            rs_found, rs = self._dbsnp_ctg.lookup(x)
        prf_ctxt = "".join(PBASE[c] for c in self.rf_ctxt[:5])
        rfc = prf_ctxt[2]
        rfix = self.rf_ctxt[2]
        gt = self.gt_store[2] - 1
        skip = (
            not cfg.all_positions
            and not (rs_found & 2)
            and bool(GT_FLAG[gt][rfix])
        )
        z = float(gtm.gt_prob[gt])
        z1 = math.exp(z * LOG10)
        if z1 >= 1.0:
            phred = 255
        else:
            phred = int(-10.0 * math.log(1.0 - z1) / LOG10)
            if phred > 255:
                phred = 255
        alt = REF_ALT[gt][rfix]
        mut = MUT_TYPE[gt][rfix]
        fs = int(-gtm.fisher_strand * 10.0 + 0.5)
        qd = phred // dp1 if dp1 > 0 else phred
        flt = 0
        if not skip:
            regions = getattr(ctg, "regions", None)
            if regions:
                # site must fall inside one of the contig's -C regions.
                # (The reference checks only curr_reg, which it never
                # advances past a contig's first region — sites in later
                # regions of the same contig are silently dropped; we treat
                # all requested regions as callable.)
                skip = not any(r.start <= x <= r.stop for r in regions)
            elif ctg.curr_reg is not None:
                skip = x < ctg.curr_reg.start or x > ctg.curr_reg.stop
            else:
                skip = x > ctg.seq_len
        site = None
        if not skip:
            if phred < 20:
                flt |= 1
            if qd < 2:
                flt |= 2
            if fs > 60:
                flt |= 4
            if gtm.mq < 40:
                flt |= 8
            if not flt:
                mac1 = False
                c = counts
                if gt == 1:
                    mac1 = c[1] + c[5] + c[7] <= 1 or c[0] + c[4] <= 1
                elif gt == 2:
                    mac1 = c[2] + c[6] <= 1 or c[0] <= 1
                elif gt == 3:
                    mac1 = c[3] + c[7] <= 1 or c[0] + c[4] <= 1
                elif gt == 5:
                    mac1 = (
                        c[2] + c[6] + c[4] <= 1 or c[1] + c[5] + c[7] <= 1
                    )
                elif gt == 6:
                    mac1 = c[3] <= 1 or c[1] + c[5] <= 1
                elif gt == 8:
                    mac1 = c[3] + c[7] <= 1 or c[2] + c[6] + c[4] <= 1
                if mac1:
                    flt |= 128
                    filters = ["mac1"]
                else:
                    filters = ["PASS"]
            else:
                filters = ["fail"]

        # genotype-called context + CpG status (uses lookahead)
        ctxt = "".join(IUPAC[g] for g in self.gt_store)
        cpg = cpg_status(self.gt_store)

        if not skip:
            # FT string from hard-filter bits. The reference copies each
            # name's terminating NUL into the typed char vector
            # (print_vcf.c:283-296: `while((*p++ = *p1++));` leaves p
            # past the NUL), so failed-filter lists carry embedded NULs
            # in the real output bytes — verified against the compiled C
            # binary (tools/htslib_shim).
            if flt & 15:
                names = [
                    FILTER_NAMES[i] for i in range(4) if (flt >> i) & 1
                ]
                ft = ";".join(n + "\0" for n in names)
            else:
                ft = "PASS"
            # GL (print_vcf.c:318-347)
            aix = ALL_IDX[gt][rfix]
            gl = []
            if rfix:
                j = rfix * (9 - rfix) // 2 + rfix - 5
                zz = float(gtm.gt_prob[j])
                if zz < -99.999:
                    zz = -99.999
            else:
                zz = -99.999
            gl.append(zz)
            for i in range(2):
                if aix[i] <= 0:
                    break
                if rfix:
                    if rfix < aix[i]:
                        j = rfix * (9 - rfix) // 2 + aix[i] - 5
                    else:
                        j = aix[i] * (9 - aix[i]) // 2 + rfix - 5
                    zz = float(gtm.gt_prob[j])
                    if zz < -99.999:
                        zz = -99.999
                    gl.append(zz)
                j = aix[i] * (9 - aix[i]) // 2 + aix[i] - 5
                zz = float(gtm.gt_prob[j])
                if zz < -99.999:
                    zz = -99.999
                gl.append(zz)
            gg = GT_INT[gt][rfix]
            amq = [int(gtm.quals[i]) for i in range(8) if counts[i] > 0]
            site = VcfSite(
                rid=ctg.vcf_rid,
                pos=x,
                rs_id=rs if rs_found else ".",
                ref=rfc,
                alts=list(alt),
                qual=phred,
                filters=filters,
                cx_info=prf_ctxt,
                gt_ints=[gg >> 4, gg & 0xF],
                ft=ft,
                dp=dp1,
                mq=int(gtm.mq),
                gq=phred,
                qd=qd,
                gl=gl,
                mc8=[int(v) for v in counts],
                amq=amq,
                cs=CS_STR[gt],
                # the reference encodes exactly ONE char for CG
                # (print_vcf.c:366-368: bcf_enc_size(str,1,CHAR) +
                # kputc_(*cpg)), so CpG sites print "C", never "CG"
                cg=cpg[0],
                cx_fmt=ctxt,
                fs=fs if GT_HET[gt] else None,
            )
            self.write(site)

        # ---- stats accumulation (print_vcf.c:382-526) ----
        stats = self.stats
        if stats is None:
            return
        snp = False
        multi = False
        gcov = stats.cov_stats[dp]
        gcov.all += 1
        ctg_stats = ctg.ctg_stats
        if ctg_stats is not None and ctg_stats.gc is not None:
            bn = (x - self._ctg_start_pos()) // 100
            if 0 <= bn < len(ctg_stats.gc):
                gc = int(ctg_stats.gc[bn])
                if gc <= 100:
                    gcov.gc_pcent[gc] += 1
        if skip:
            return
        if self.cfg.reference_quirks:
            # print_vcf.c's ALT loop (:177-181) leaves `alt` on its NUL,
            # so the gate at :400 counts EVERY emitted site as a SNP and
            # :401 never sees a comma (vector_site.variant_gate_luts)
            snp = True
        elif alt and alt[0] != ".":
            if len(alt) > 1:
                multi = True
            else:
                snp = True
        if snp or multi:
            if snp:
                stats.snps[0] += 1
                if ctg_stats:
                    ctg_stats.snps[0] += 1
                if not flt:
                    stats.snps[1] += 1
                    if ctg_stats:
                        ctg_stats.snps[1] += 1
            else:
                stats.multi[0] += 1
                if ctg_stats:
                    ctg_stats.multi[0] += 1
                if not flt:
                    stats.multi[1] += 1
                    if ctg_stats:
                        ctg_stats.multi[1] += 1
            stats.qual[1][phred] += 1
            gcov.var += 1
        het = bool(GT_HET[gt])
        stats.qd_stats[qd][1 if het else 0] += 1
        stats.fs_stats[fs][1 if het else 0] += 1
        stats.mq_stats[int(gtm.mq)][1 if het else 0] += 1
        stats.filter_counts[1 if het else 0][flt & 31] += 1
        stats.qual[0][phred] += 1
        if rs_found:
            stats.dbSNP_sites[0] += 1
            if ctg_stats:
                ctg_stats.dbSNP_sites[0] += 1
            if snp or multi:
                stats.dbSNP_var[0] += 1
                if ctg_stats:
                    ctg_stats.dbSNP_var[0] += 1
            if not flt:
                stats.dbSNP_sites[1] += 1
                if ctg_stats:
                    ctg_stats.dbSNP_sites[1] += 1
                if snp or multi:
                    stats.dbSNP_var[1] += 1
                    if ctg_stats:
                        ctg_stats.dbSNP_var[1] += 1
        if cpg == "CG":
            ref_cpg = False
            cpg_ok = False
            a = b = 0
            cs = CS_STR[gt]
            if cs == "+":
                lag.prev_cpg_x = x
                lag.prev_cpg_flt = flt != 0
                if prf_ctxt[2:4] == "CG":
                    ref_cpg = True
                a = int(counts[5])
                b = int(counts[7])
                cpg_ok = True
            elif cs == "-":
                if prf_ctxt[1:3] == "CG":
                    ref_cpg = True
                if x - lag.prev_cpg_x == 1:
                    key = "CpG_ref" if ref_cpg else "CpG_nonref"
                    getattr(stats, key)[0] += 1
                    if ctg_stats:
                        getattr(ctg_stats, key)[0] += 1
                    if not (lag.prev_cpg_flt or flt):
                        getattr(stats, key)[1] += 1
                        if ctg_stats:
                            getattr(ctg_stats, key)[1] += 1
                a = int(counts[6])
                b = int(counts[4])
                cpg_ok = True
            if cpg_ok:
                stats.qual[2 if ref_cpg else 3][phred] += 1
                gcov.CpG[0 if ref_cpg else 1] += 1
                gcov1 = stats.cov_stats[d_inf]
                gcov1.CpG_inf[0 if ref_cpg else 1] += 1
                if a + b:
                    # methylation posterior over 101-point grid
                    # (print_vcf.c:491-514)
                    konst = _lfact(a + b + 1) - _lfact(a) - _lfact(b)
                    meth = np.zeros(101)
                    s = 0.0
                    if a:
                        meth[0] = 0.0
                    else:
                        meth[0] = math.exp(konst)
                        s = meth[0]
                    if b:
                        meth[100] = 0.0
                    else:
                        meth[100] = math.exp(konst)
                        s = meth[100]
                    da, db = float(a), float(b)
                    for i in range(1, 100):
                        meth[i] = math.exp(
                            konst + _LOGP[i - 1] * da + _LOGP[99 - i] * db
                        )
                        s += meth[i]
                    dst = (
                        stats.CpG_ref_meth if ref_cpg else stats.CpG_nonref_meth
                    )
                    zz = meth / s
                    dst[0] += zz
                    if not flt:
                        dst[1] += zz
        if mut != MUT_NO:
            stats.mut_counts[mut][0] += 1
            if not flt:
                stats.mut_counts[mut][1] += 1
            if rs_found:
                stats.dbSNP_mut_counts[mut][0] += 1
                if not flt:
                    stats.dbSNP_mut_counts[mut][1] += 1

    def _ctg_start_pos(self) -> int:
        # gc bins are laid out from the contig's first non-N base
        return getattr(self.curr_ctg, "gc_start_pos", 1)
