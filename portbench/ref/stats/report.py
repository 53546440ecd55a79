"""JSON stats report writer.

Byte-layout contract: stats.c:19-298 (output_stats). The reference
hand-writes this JSON with fprintf including its quirks (hardcoded
"bs_call_v2.1" source, "bq_thread" typo, a missing newline before
VCFFilterStats, 12-entries-per-line coverage maps, 16-per-line arrays) —
all reproduced so downstream parsers see an identical document.
"""

from __future__ import annotations

import time

MUT_TYPE = [
    "A>C", "A>G", "A>T", "C>A", "C>G", "C>T",
    "G>A", "G>C", "G>T", "T>A", "T>C", "T>G",
]
FILTER_NAMES = [
    "Passed", "Unmapped", "QC_Flags", "SecondaryAlignment", "MateUnmapped",
    "Duplicate", "NoPosition", "NoMatePosition", "MismatchContig",
    "BadOrientation", "LargeInsertSize", "NoSequence", "LowMAPQ",
    "NotCorrectlyAligned", "PairNotFound",
]
BASE_FILTERS = ["Passed", "Trimmed", "Clipped", "Overlapping", "LowQuality"]
FLT_NAME = ["q20", "qd2", "fs60", "mq40"]


def _g(v: float) -> str:
    return "%g" % v


def write_report(fp, cfg, stats, table, dbsnp=None):
    w = fp.write
    w(
        '{\n\t"source": "bs_call_v2.1, under_conversion=%g, '
        'over_conversion=%g, mapq_thresh=%d, bq_thread=%d",\n'
        % (cfg.under_conv, cfg.over_conv, cfg.mapq_thresh, cfg.min_qual)
    )
    tt = time.localtime()
    w('\t"date": "%02d/%02d/%04d",\n' % (tt.tm_mday, tt.tm_mon, tt.tm_year))
    w('\t"filterStats": {\n\t\t"ReadLevel": {\n')
    w(
        '\t\t\t"%s": {\n\t\t\t\t"Reads": %d,\n\t\t\t\t"Bases": %d\n\t\t\t}'
        % (FILTER_NAMES[0], stats.filter_cts[0], stats.filter_bases[0])
    )
    for i in range(1, 15):
        if stats.filter_cts[i] > 0:
            w(
                ',\n\t\t\t"%s": {\n\t\t\t\t"Reads": %d,\n\t\t\t\t"Bases": %d\n\t\t\t}'
                % (FILTER_NAMES[i], stats.filter_cts[i], stats.filter_bases[i])
            )
    w('\n\t\t},\n\t\t"BaseLevel": {\n')
    w('\t\t\t"%s": %d' % (BASE_FILTERS[0], stats.base_filter[0]))
    for i in range(1, 5):
        if stats.base_filter[i] > 0:
            w(',\n\t\t\t"%s": %d' % (BASE_FILTERS[i], stats.base_filter[i]))
    w('\n\t\t}\n\t},\n\t"totalStats": {\n')
    w(
        '\t\t"SNPS": {\n\t\t\t"All": %d,\n\t\t\t"Passed": %d\n\t\t},\n'
        % (stats.snps[0], stats.snps[1])
    )
    w(
        '\t\t"Indels": {\n\t\t\t"All": %d,\n\t\t\t"Passed": %d\n\t\t},\n'
        % (stats.indels[0], stats.indels[1])
    )
    w(
        '\t\t"Multiallelic": {\n\t\t\t"All": %d,\n\t\t\t"Passed": %d\n\t\t},\n'
        % (stats.multi[0], stats.multi[1])
    )
    if dbsnp is not None:
        w(
            '\t\t"dbSNPSites": {\n\t\t\t"All": %d,\n\t\t\t"Passed": %d\n\t\t},\n'
            % (stats.dbSNP_sites[0], stats.dbSNP_sites[1])
        )
        w(
            '\t\t"dbSNPVariantSites": {\n\t\t\t"All": %d,\n\t\t\t"Passed": %d\n\t\t},\n'
            % (stats.dbSNP_var[0], stats.dbSNP_var[1])
        )
    w(
        '\t\t"RefCpG": {\n\t\t\t"All": %d,\n\t\t\t"Passed": %d\n\t\t},\n'
        % (stats.CpG_ref[0], stats.CpG_ref[1])
    )
    w(
        '\t\t"NonRefCpG": {\n\t\t\t"All": %d,\n\t\t\t"Passed": %d\n\t\t},\n'
        % (stats.CpG_nonref[0], stats.CpG_nonref[1])
    )
    w('\t\t"QCDistributions": {\n')
    # FisherStrand: variant counts only
    w('\t\t\t"FisherStrand": ')
    term = "{"
    for k in sorted(stats.fs_stats):
        c = stats.fs_stats[k]
        if c[1] > 0:
            w('%s\n\t\t\t\t"%d": %d' % (term, k, c[1]))
            term = ","
    if term == "{":
        w(term)
    w("\n\t\t\t},\n")
    for label, d in (
        ("QualityByDepth", stats.qd_stats),
        ("RMSMappingQuality", stats.mq_stats),
    ):
        w('\t\t\t"%s": ' % label)
        term = "{"
        for k in sorted(d):
            c = d[k]
            if c[0] + c[1] > 0:
                w(
                    '%s\n\t\t\t\t"%d": {"NonVariant": %d, "Variant": %d}'
                    % (term, k, c[0], c[1])
                )
                term = ","
        if term == "{":
            w(term)
        if label == "QualityByDepth":
            w("\n\t\t\t},\n")
    # NOTE: reference omits the newline after this closing brace
    # (stats.c:91)
    w('\n\t\t\t}\n\t\t},\t\t"VCFFilterStats": {\n')
    w(
        '\t\t\t"PASS": {"NonVariant": %d, "Variant": %d}'
        % (stats.filter_counts[0][0], stats.filter_counts[1][0])
    )
    for i in range(1, 16):
        w(",\n\t\t\t")
        k = i
        f_ix = 0
        tmp = '"'
        while k:
            if k & 1:
                w("%s%s" % (tmp, FLT_NAME[f_ix]))
                tmp = ","
            k >>= 1
            f_ix += 1
        w(
            '": {"NonVariant": %d, "Variant": %d}'
            % (stats.filter_counts[0][i], stats.filter_counts[1][i])
        )
    w("\n\t\t},\n")
    covs = sorted(stats.cov_stats)
    w('\t\t"coverage": {\n')

    def cov_map(label, getter, trailing=",\n"):
        w('\t\t\t"%s": ' % label)
        term = "{"
        ix = 0
        for cov in covs:
            v = getter(stats.cov_stats[cov])
            if v != 0:
                ix += 1
                if ix % 12 == 1:
                    w("%s\n\t\t\t\t" % term)
                    term = ","
                else:
                    w(", ")
                w('"%d": %d' % (cov, v))
                ix %= 12
        if term == "{":
            # reference emits no brace for an empty map (invalid JSON,
            # stats.c:163-176); we emit it so the document stays parseable
            w(term)
        w("\n\t\t\t}" + trailing)

    cov_map("All", lambda c: c.all)
    cov_map("Variant", lambda c: c.var)
    cov_map("RefCpG", lambda c: c.CpG[0])
    cov_map("RefCpGInf", lambda c: c.CpG_inf[0])
    cov_map("NonRefCpG", lambda c: c.CpG[1])
    cov_map("NonRefCpGInf", lambda c: c.CpG_inf[1], trailing=",\n")
    w('\t\t\t"GC": ')
    term = "{"
    for cov in covs:
        c = stats.cov_stats[cov]
        if not c.all:
            continue
        w('%s\n\t\t\t\t"%d": [\n\t\t\t\t\t' % (term, cov))
        term = ","
        for i in range(100):
            w("%d," % c.gc_pcent[i])
            if (i & 15) == 15:
                w("\n\t\t\t\t\t")
            else:
                w(" ")
        w("%d\n\t\t\t\t]" % c.gc_pcent[100])
    w('\n\t\t\t}\n\t\t},\n\t\t"quality": {\n')

    def qual_array(label, row, last=False):
        w('\t\t\t"%s": [\n\t\t\t\t' % label)
        if label == "All":
            for i in range(255):
                w("%d, " % row[i])
                if (i & 15) == 15:
                    w("\n\t\t\t\t")
            w("%d\n\t\t\t]" % row[255])
        else:
            for i in range(255):
                w("%d," % row[i])
                if (i & 15) == 15:
                    w("\n\t\t\t\t")
                else:
                    w(" ")
            w("%d\n\t\t\t]" % row[255])
        w("\n" if last else ",\n")

    qual_array("All", stats.qual[0])
    qual_array("Variant", stats.qual[1])
    qual_array("RefCpG", stats.qual[2])
    qual_array("NonRefCpG", stats.qual[3], last=True)
    w('\t\t},\n\t\t"mutations": {\n')
    for mut in range(12):
        end = ",\n" if mut < 11 else "\n"
        w(
            '\t\t\t"%s": { "All": %d, "Passed": %d, "dbSNPAll": %d, '
            '"dbSNPPassed": %d }%s'
            % (
                MUT_TYPE[mut],
                stats.mut_counts[mut][0],
                stats.mut_counts[mut][1],
                stats.dbSNP_mut_counts[mut][0],
                stats.dbSNP_mut_counts[mut][1],
                end,
            )
        )
    w('\t\t},\n\t\t"methylation": {\n')

    def meth_array(label, row, last=False):
        w('\t\t\t"%s": [\n\t\t\t\t' % label)
        for i in range(100):
            w("%.8g, " % row[i])
            if (i & 15) == 15:
                w("\n\t\t\t\t")
        w("%.8g\n\t\t\t]" % row[100])
        if not last:
            w(",\n")

    meth_array("AllRefCpg", stats.CpG_ref_meth[0])
    meth_array("PassedRefCpg", stats.CpG_ref_meth[1])
    meth_array("AllNonRefCpg", stats.CpG_nonref_meth[0])
    meth_array("PassedNonRefCpg", stats.CpG_nonref_meth[1], last=True)
    nr = stats.meth_profile_used
    if nr:
        w(',\n\t\t\t"NonCpGreadProfile": ')
        term = "["
        for i in range(1, nr):
            mc = stats.meth_profile[i]
            w(
                "%s\n\t\t\t\t[ %d, %d, %d, %d ]"
                % (term, mc[0], mc[1], mc[2], mc[3])
            )
            term = ","
        w("\n\t\t\t]")
    w('\n\t\t}\n\t},\n\t"contigStats": ')
    term = "{"
    for ctg in table.contigs:
        gs = ctg.ctg_stats
        if gs is None or gs.snps[0] == 0:
            continue
        w('%s\n\t\t"%s": {\n' % (term, ctg.name))
        term = ","
        w(
            '\t\t\t"SNPS": {\n\t\t\t\t"All": %d,\n\t\t\t\t"Passed": %d\n\t\t\t},\n'
            % (gs.snps[0], gs.snps[1])
        )
        w(
            '\t\t\t"Indels": {\n\t\t\t\t"All": %d,\n\t\t\t\t"Passed": %d\n\t\t\t},\n'
            % (gs.indels[0], gs.indels[1])
        )
        w(
            '\t\t\t"Multiallelic": {\n\t\t\t\t"All": %d,\n\t\t\t\t"Passed": %d\n\t\t\t},\n'
            % (gs.multi[0], gs.multi[1])
        )
        if dbsnp is not None:
            w(
                '\t\t\t"dbSNPSites": {\n\t\t\t\t"All": %d,\n\t\t\t\t"Passed": %d\n\t\t\t},\n'
                % (gs.dbSNP_sites[0], gs.dbSNP_sites[1])
            )
            w(
                '\t\t\t"dbSNPVariantSites": {\n\t\t\t\t"All": %d,\n\t\t\t\t"Passed": %d\n\t\t\t},\n'
                % (gs.dbSNP_var[0], gs.dbSNP_var[1])
            )
        w(
            '\t\t\t"RefCpG": {\n\t\t\t\t"All": %d,\n\t\t\t\t"Passed": %d\n\t\t\t},\n'
            % (gs.CpG_ref[0], gs.CpG_ref[1])
        )
        w(
            '\t\t\t"NonRefCpG": {\n\t\t\t\t"All": %d,\n\t\t\t\t"Passed": %d\n\t\t\t}\n\t\t}'
            % (gs.CpG_nonref[0], gs.CpG_nonref[1])
        )
    if term == "{":
        # reference omits the brace when no contig has SNPs (invalid
        # JSON, stats.c:280-297); emit it so the document parses
        w(term)
    w("\n\t}\n}\n")
