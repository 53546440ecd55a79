"""dbSNP index builder: bs_call's compressed binary index from SNPs added
one by one (`add_snp`), as `utils/synth.py` builds its fixtures' indexes.
The JAX package's `bs_call_tpu.io.dbsnp_idx` also parses dbSNP
distributions (BED / VCF / NCBI refsnp JSON) and is the offline tool.

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

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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
                if pool is None:
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

