"""dbSNP index builder — offline tool converting dbSNP distributions
(BED / VCF / NCBI refsnp JSON) into bs_call's compressed binary index,
the reference's second binary (dbSNP_idx):

    python -m bs_call_tpu_torch.io.dbsnp_idx -o idx.bin snps.vcf.gz ...

Format contract (writer side): dbSNP_output.c:139-299, dbSNP_bins.c:73-116,
dbSNP_input.c:110-160, dbSNP_json.c. Files produced here load with both
the reference's dbSNP.c reader and bs_call_tpu_torch.io.dbsnp.

Layout summary:
  [0:32]  magic u32, reserved u32, header_offset u64, max_buf_size u64,
          header_comp_size u64
  [32:]   per-contig data: { u64 comp_size, zlib block }*, u64 0 terminator
  [hdr]   zlib block: u8 version=2, u8 0, u16 n_prefix, u32 n_ctgs,
          track line\0, prefix\0*, { u32 min_bin, u32 max_bin, u64 offset,
          name\0 }*
  tail    magic u32
"""

from __future__ import annotations

import json
import struct
import sys
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO, Tuple

MAGIC = 0xD7278434
ITEMS_PER_BLOCK = 2048  # bins per compressed block (dbSNP_idx.h:26)

# digit-pair -> file byte (dtab2, dbSNP_output.c:17-29): pairs 00..99 map to
# bytes 33..132, single digit + terminator to 133..142
def _pack_byte(d1: int, d2: Optional[int]) -> int:
    if d2 is None:
        return 133 + d1
    return 33 + d1 * 10 + d2


@dataclass
class Bin:
    mask: int = 0
    fq_mask: int = 0
    entries: List[Tuple[int, int, int]] = field(default_factory=list)
    # (offset_in_bin, prefix_ix, digits-string) per entry in insert order
    names: List[str] = field(default_factory=list)


@dataclass
class ContigBins:
    name: str
    min_bin: int
    max_bin: int
    bins: Dict[int, Bin] = field(default_factory=dict)
    offset: int = 0


class DbSnpIndexBuilder:
    def __init__(
        self,
        maf_limit: float = 1.0,
        select_names=None,
        aliases: Optional[Dict[str, str]] = None,
        header: Optional[str] = None,
    ):
        self.maf_limit = maf_limit
        self.select_names = set(select_names or [])
        self.aliases = aliases
        self.header = header
        self.prefixes: Dict[str, int] = {}
        self.contigs: Dict[str, ContigBins] = {}
        self.n_snps = 0
        self.max_buf_size = 0
        self.prebuilt = None  # name -> pre-compressed blocks (parallel build)

    # ---- input ----

    def _prefix_ix(self, pref: str) -> int:
        if pref not in self.prefixes:
            self.prefixes[pref] = len(self.prefixes)
        return self.prefixes[pref]

    def add_snp(self, cname: str, pos: int, name: str, maf: float = -1.0):
        """pos semantics follow the input format (BED: end coordinate;
        VCF: POS; JSON: SPDI position) exactly as the reference does."""
        if self.aliases is not None:
            cname = self.aliases.get(cname)
            if cname is None:
                return
        # split name into prefix + digit suffix (dbSNP_input.c:155-160)
        k = len(name)
        while k > 0 and name[k - 1].isdigit():
            k -= 1
        pref_ix = self._prefix_ix(name[:k])
        digits = name[k:]
        binx = pos >> 6
        ctg = self.contigs.get(cname)
        if ctg is None:
            ctg = self.contigs[cname] = ContigBins(cname, binx, binx)
        ctg.min_bin = min(ctg.min_bin, binx)
        ctg.max_bin = max(ctg.max_bin, binx)
        b = ctg.bins.setdefault(binx, Bin())
        off = pos & 63
        msk = 1 << off
        if b.mask & msk:
            return
        b.mask |= msk
        select = maf >= self.maf_limit
        if not select and name in self.select_names:
            select = True
        if select:
            b.fq_mask |= 1 << len(b.entries)
        b.entries.append((off, pref_ix, digits))
        self.n_snps += 1

    def read_stream(self, fp: TextIO, input_type: str = "auto"):
        for line in fp:
            line = line.rstrip("\n")
            if not line:
                continue
            if input_type == "auto":
                if line[0] == "{":
                    input_type = "json"
                elif line.startswith("##fileformat=VCF"):
                    input_type = "vcf"
                else:
                    input_type = "bed"
            if input_type == "bed":
                self._parse_bed(line)
            elif input_type == "vcf":
                self._parse_vcf(line)
            else:
                self._parse_json(line)

    def _parse_bed(self, line: str):
        if line.startswith("track ") and self.header is None:
            self.header = line
            return
        f = line.split("\t")
        if len(f) > 4:
            try:
                x = int(f[1])
                y = int(f[2])
            except ValueError:
                return
            if y > x and y - x == 1:
                self.add_snp(f[0], y, f[3])

    def _parse_vcf(self, line: str):
        if line.startswith("#"):
            return
        f = line.split("\t")
        if len(f) > 4 and len(f[3]) == 1 and len(f[4]) == 1:
            try:
                pos = int(f[1])
            except ValueError:
                return
            self.add_snp(f[0], pos, f[2])

    def _parse_json(self, line: str):
        """NCBI refsnp JSON line (dbSNP_json.c semantics)."""
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            return
        name = obj.get("refsnp_id")
        psd = obj.get("primary_snapshot_data") or {}
        pos = cname = None
        ins_seq = del_seq = None
        for pl in psd.get("placements_with_allele", []):
            if not pl.get("is_ptlp"):
                continue
            for a in pl.get("alleles", []):
                spdi = (a.get("allele") or {}).get("spdi") or {}
                ins = spdi.get("inserted_sequence")
                dele = spdi.get("deleted_sequence")
                if (
                    isinstance(ins, str)
                    and isinstance(dele, str)
                    and len(ins) == 1
                    and len(dele) == 1
                    and ins != dele
                    and isinstance(spdi.get("position"), int)
                ):
                    pos = spdi["position"]
                    cname = spdi.get("seq_id")
                    ins_seq, del_seq = ins, dele
        if name is None or pos is None or cname is None:
            return
        allele_count = total_count = 0
        for ann in psd.get("allele_annotations", []):
            for fr in ann.get("frequency", []):
                obs = fr.get("observation") or {}
                if (
                    obs.get("inserted_sequence") == ins_seq
                    and obs.get("deleted_sequence") == del_seq
                    and "study_name" in fr
                    and isinstance(fr.get("allele_count"), int)
                    and isinstance(fr.get("total_count"), int)
                    and fr["allele_count"] <= fr["total_count"]
                ):
                    allele_count += fr["allele_count"]
                    total_count += fr["total_count"]
        maf = -1.0
        if total_count > 0:
            z = allele_count / total_count
            if z > 0.5:
                z = 1.0 - z
            maf = z
        self.add_snp(cname, pos, "rs" + str(name), maf)

    # ---- merging (parallel builds) ----

    def merge_from(self, other: "DbSnpIndexBuilder"):
        """Fold another builder (one input file's worth) into this one,
        preserving serial-order semantics: this builder's entries came
        first, so cross-file duplicate positions keep the earlier file's
        name, exactly as a serial pass over the files would."""
        if self.header is None:
            self.header = other.header
        remap = [self._prefix_ix(p) for p in other.prefixes]
        identity = all(r == i for i, r in enumerate(remap))
        for cname, octg in other.contigs.items():
            ctg = self.contigs.get(cname)
            if ctg is None and identity:
                # disjoint contig + same prefix table (the per-chromosome
                # layout): adopt the shard's bins wholesale — no
                # per-entry work, so the parallel build's merge cost is
                # just the transport
                self.contigs[cname] = octg
                self.n_snps += sum(
                    len(b.entries) for b in octg.bins.values()
                )
                continue
            if ctg is None:
                ctg = self.contigs[cname] = ContigBins(
                    cname, octg.min_bin, octg.max_bin
                )
            ctg.min_bin = min(ctg.min_bin, octg.min_bin)
            ctg.max_bin = max(ctg.max_bin, octg.max_bin)
            for binx, ob in octg.bins.items():
                b = ctg.bins.setdefault(binx, Bin())
                for j, (off, pref_ix, digits) in enumerate(ob.entries):
                    msk = 1 << off
                    if b.mask & msk:
                        continue
                    b.mask |= msk
                    if (ob.fq_mask >> j) & 1:
                        b.fq_mask |= 1 << len(b.entries)
                    b.entries.append((off, remap[pref_ix], digits))
                    self.n_snps += 1

    # ---- output ----

    def _encode_contig(self, ctg: ContigBins) -> List[bytes]:
        """Returns the zlib-compressed blocks for one contig."""
        return [zlib.compress(bytes(b)) for b in self._raw_blocks(ctg)]

    def _raw_blocks(self, ctg: ContigBins) -> List[bytearray]:
        """Uncompressed serialized blocks (ITEMS_PER_BLOCK bins each) for
        one contig — the compression step is separate so -@ can fan it
        out to a pool (the reference's compress_thread ring,
        dbSNP_idx.c:53-93)."""
        blocks = []
        buf = bytearray()
        curr_bin = ctg.min_bin
        n_items = 0
        for i in range(ctg.min_bin, ctg.max_bin + 1):
            b = ctg.bins.get(i)
            if b is None or not b.entries:
                continue
            k = i - curr_bin
            if k < 64:
                buf.append(k << 2)
            elif k < 256:
                buf.append(1)
                buf.append(k)
            elif k < 65536:
                buf.append(2)
                buf += struct.pack("<H", k)
            else:
                buf.append(3)
                buf += struct.pack("<I", k)
            curr_bin = i
            order = sorted(range(len(b.entries)), key=lambda j: b.entries[j][0])
            terminator = 0
            for rank, j1 in enumerate(order):
                if rank:
                    buf.append(terminator)
                off, pref_ix, digits = b.entries[j1]
                terminator = 2 if (b.fq_mask >> j1) & 1 else 0
                xb = off
                if pref_ix < 3:
                    xb |= (pref_ix + 1) << 6
                buf.append(xb)
                if pref_ix >= 3:
                    # reference writes little-endian here but reads
                    # big-endian (dbSNP.c:332) — format kept verbatim
                    buf += struct.pack("<H", pref_ix)
                ds = [int(c) for c in digits]
                for z in range(0, len(ds) - 1, 2):
                    buf.append(_pack_byte(ds[z], ds[z + 1]))
                if len(ds) % 2:
                    buf.append(_pack_byte(ds[-1], None))
            buf.append(terminator | 1)
            n_items += 1
            if n_items == ITEMS_PER_BLOCK:
                self.max_buf_size = max(self.max_buf_size, len(buf))
                blocks.append(buf)
                buf = bytearray()
                n_items = 0
        if n_items > 0 or not blocks:
            self.max_buf_size = max(self.max_buf_size, len(buf))
            blocks.append(buf)
        return blocks

    def write(self, path: str, threads: int = 1):
        """Serialize the index. threads > 1 fans the per-block zlib
        deflate out to a pool (zlib releases the GIL); blocks are written
        in order at the same level, so the bytes are identical to the
        serial path."""
        pool = None
        if threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=threads)
        try:
            self._write(path, pool)
        finally:
            if pool is not None:
                pool.shutdown()

    def _write(self, path: str, pool):
        with open(path, "wb") as fp:
            fp.seek(32)
            for ctg in self.contigs.values():
                ctg.offset = fp.tell()
                if self.prebuilt is not None and ctg.name in self.prebuilt:
                    blks = self.prebuilt[ctg.name]
                elif pool is None:
                    blks = self._encode_contig(ctg)
                else:
                    blks = list(
                        pool.map(
                            lambda b: zlib.compress(bytes(b)),
                            self._raw_blocks(ctg),
                        )
                    )
                for blk in blks:
                    fp.write(struct.pack("<Q", len(blk)))
                    fp.write(blk)
                fp.write(struct.pack("<Q", 0))
            hdr_off = fp.tell()
            hdr = bytearray()
            hdr += struct.pack("<BBH", 2, 0, len(self.prefixes))
            hdr += struct.pack("<I", len(self.contigs))
            track = self.header or (
                "track name = dbSNP_index description = "
                '"dbSNP index produced by dbSNP_idx"'
            )
            hdr += track.encode() + b"\x00"
            for pref in self.prefixes:
                hdr += pref.encode() + b"\x00"
            for ctg in self.contigs.values():
                hdr += struct.pack("<IIQ", ctg.min_bin, ctg.max_bin, ctg.offset)
                hdr += ctg.name.encode() + b"\x00"
            self.max_buf_size = max(self.max_buf_size, len(hdr))
            comp = zlib.compress(bytes(hdr))
            fp.write(comp)
            fp.write(struct.pack("<I", MAGIC))
            fp.seek(0)
            fp.write(struct.pack("<II", MAGIC, 0))
            fp.write(
                struct.pack("<QQQ", hdr_off, self.max_buf_size, len(comp))
            )


def _parse_one_file(job):
    """Worker-process body of the parallel build: one file -> one
    builder shard (picklable; merged by the parent in file order)."""
    path, input_type, maf_limit, select_names, aliases = job
    shard = DbSnpIndexBuilder(
        maf_limit=maf_limit, select_names=select_names, aliases=aliases
    )
    with _open_maybe_compressed(path) as f:
        shard.read_stream(f, input_type)
    return shard


def _build_one_file(job):
    """Worker-process body of the fast parallel build: parse one file AND
    encode+compress its contig sections, shipping only the final bytes
    (the reference's reader->serializer->compressor pipeline collapsed
    into one worker per file, dbSNP_idx.c:53-93)."""
    shard = _parse_one_file(job)
    contigs = []
    for ctg in shard.contigs.values():
        contigs.append(
            (
                ctg.name,
                ctg.min_bin,
                ctg.max_bin,
                shard._encode_contig(ctg),
            )
        )
    return {
        "prefixes": list(shard.prefixes),
        "header": shard.header,
        "n_snps": shard.n_snps,
        "max_buf_size": shard.max_buf_size,
        "contigs": contigs,
    }


def _merge_prebuilt(builder, shards) -> bool:
    """Fold worker-encoded sections into `builder` as pre-compressed
    contig payloads. Byte-identical to the serial build iff contig sets
    are pairwise disjoint and every shard's prefix table is a prefix of
    the merged first-seen order; returns False when those assumptions
    fail (caller falls back to the serial path)."""
    global_prefixes: List[str] = []
    seen_contigs = set()
    for sh in shards:
        for i, p in enumerate(sh["prefixes"]):
            if i < len(global_prefixes):
                if global_prefixes[i] != p:
                    return False
            else:
                global_prefixes.append(p)
        for name, _mn, _mx, _blks in sh["contigs"]:
            if name in seen_contigs:
                return False
            seen_contigs.add(name)
    for p in global_prefixes:
        builder._prefix_ix(p)
    builder.prebuilt = {}
    for sh in shards:
        if builder.header is None:
            builder.header = sh["header"]
        builder.n_snps += sh["n_snps"]
        builder.max_buf_size = max(
            builder.max_buf_size, sh["max_buf_size"]
        )
        for name, mn, mx, blks in sh["contigs"]:
            builder.contigs[name] = ContigBins(name, mn, mx)
            builder.prebuilt[name] = blks
    return True


def _open_maybe_compressed(path: str):
    """Text stream with magic-byte compression sniffing (the reference
    forks gzip/bzip2/xz children, dbSNP_utils.c:163-242; here the Python
    codec modules serve the same formats in-process)."""
    with open(path, "rb") as probe:
        magic = probe.read(6)
    if magic[:2] == b"\x1f\x8b":
        import gzip

        return gzip.open(path, "rt")
    if magic[:3] == b"BZh":
        import bz2

        return bz2.open(path, "rt")
    if magic[:6] == b"\xfd7zXZ\x00":
        import lzma

        return lzma.open(path, "rt")
    return open(path, "r")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="dbsnp_idx",
        description="Build a bs_call dbSNP index from BED/VCF/JSON input",
    )
    p.add_argument("inputs", nargs="*", help="input files (default stdin)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-d", "--description", default=None, help="track header")
    p.add_argument(
        "-t", "--type", choices=["AUTO", "BED", "JSON", "VCF"], default="AUTO"
    )
    p.add_argument("-c", "--chrom-alias", default=None)
    p.add_argument("-s", "--selected", default=None)
    p.add_argument("-m", "--maf-limit", type=float, default=1.0)
    p.add_argument("-u", "--unsorted", action="append", default=[])
    p.add_argument(
        "-S", "--sorted", action="store_true",
        help="inputs are contig-sorted (scheduling hint in the reference, "
        "dbSNP_command_line.c:97-99; accepted for CLI parity — the "
        "builder sorts bins regardless)",
    )
    p.add_argument("-@", "--threads", type=int, default=0)
    args = p.parse_args(argv)
    aliases = None
    if args.chrom_alias:
        aliases = {}
        with open(args.chrom_alias) as f:
            for line in f:
                fld = line.rstrip("\n").split("\t")
                if len(fld) >= 2 and fld[0] not in aliases:
                    aliases[fld[0]] = fld[1]
    select = None
    if args.selected:
        with open(args.selected) as f:
            select = [l.strip() for l in f if l.strip()]
    maf = args.maf_limit
    if not (0.0 <= maf <= 0.5):
        if maf != 1.0:
            print("--maf-limit must be between 0 and 0.5", file=sys.stderr)
        maf = 1.0 if maf == 1.0 else maf
    builder = DbSnpIndexBuilder(
        maf_limit=args.maf_limit if 0.0 <= args.maf_limit <= 0.5 else 1.0,
        select_names=select,
        aliases=aliases,
        header=("track " + args.description) if args.description else None,
    )
    files = list(args.inputs) + list(args.unsorted)
    threads = max(0, args.threads)
    if not files:
        builder.read_stream(sys.stdin, args.type.lower())
    elif threads > 1 and len(files) > 1:
        # the reference's N-reader pipeline (dbSNP_idx.c:53-93): parse
        # each file into its own builder in a worker PROCESS (Python
        # parsing is GIL-bound), then fold shards in FILE ORDER so dedup
        # and prefix-id assignment match the serial pass byte-for-byte
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        jobs = [
            (
                path,
                args.type.lower(),
                builder.maf_limit,
                sorted(builder.select_names),
                aliases,
            )
            for path in files
        ]
        with ctx.Pool(min(threads, len(files))) as pool:
            shards = pool.map(_build_one_file, jobs)
        if not _merge_prebuilt(builder, shards):
            # shards share a contig or disagree on prefix order: re-parse
            # per file and fold with the entry-level merge, which
            # preserves serial dedup/prefix semantics exactly (rare;
            # per-chromosome distributions are disjoint)
            builder = DbSnpIndexBuilder(
                maf_limit=builder.maf_limit,
                select_names=builder.select_names,
                aliases=aliases,
                header=builder.header,
            )
            for job in jobs:
                builder.merge_from(_parse_one_file(job))
    else:
        for path in files:
            with _open_maybe_compressed(path) as f:
                builder.read_stream(f, args.type.lower())
    builder.write(args.output, threads=threads)
    print(
        f"Indexed {builder.n_snps} SNPs in {len(builder.contigs)} contigs",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
