"""Concatenate per-shard / per-host caller outputs: the port's copy of
`bs_call_tpu/concat.py`, on the port's `shard_runner.concat_vcfs`.

The reference's whole-genome workflow runs one caller per contig group
and merges with `bcftools concat` (README.md:73-76); `--shards` does this
in-process, and multi-host runs leave one output per host. This utility
is the standalone merge step for those per-host files: uniform headers
(the -s contract) make the inputs concat-compatible, and the k-way merge
streams — nothing is materialized.

Usage:
    python -m bs_call_tpu_torch.concat host0.vcf host1.vcf -o merged.vcf
    python -m bs_call_tpu_torch.concat host*.bcf -o merged.bcf -O b
"""

from __future__ import annotations

import argparse
import sys

from bs_call_tpu_torch import constants as C
from bs_call_tpu_torch.parallel.shard_runner import _open_auto, concat_vcfs


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="bs_call_concat",
        description="Concatenate uniform-header bs_call shard/host outputs",
    )
    p.add_argument("inputs", nargs="+", help="per-shard/host VCF or raw BCF")
    p.add_argument("-o", "--output", required=True)
    p.add_argument(
        "-O", "--output-type", choices=list("buzv"), default=None,
        help="b: compressed BCF, u: raw BCF, z: vcf.gz, v: VCF "
        "(default: guessed from the output name)",
    )
    p.add_argument("-@", "--threads", type=int, default=0)
    args = p.parse_args(argv)

    ft_map = {"v": C.FT_VCF, "z": C.FT_VCF_GZ, "u": C.FT_BCF, "b": C.FT_BCF_GZ}
    if args.output_type:
        ft = ft_map[args.output_type]
    elif args.output.endswith(".vcf.gz"):
        ft = C.FT_VCF_GZ
    elif args.output.endswith(".bcf"):
        ft = C.FT_BCF_GZ
    else:
        ft = C.FT_VCF

    # input kinds must be uniform and agree with the output encoding
    # (this tool concatenates; it does not transcode between VCF and BCF)
    kinds = {k for k in (_kind(p) for p in args.inputs)}
    if None in kinds or len(kinds) != 1:
        print(
            "inputs must all be VCF text (.vcf/.vcf.gz) or all BCF",
            file=sys.stderr,
        )
        return 1
    kind = kinds.pop()
    want_bcf = ft in (C.FT_BCF, C.FT_BCF_GZ)
    if (kind == "bcf") != want_bcf:
        print(
            f"inputs are {kind} but the output encoding is "
            f"{'BCF' if want_bcf else 'VCF'}; concat does not transcode "
            "(pick a matching -O)",
            file=sys.stderr,
        )
        return 1

    # contig order from the first input's header (uniform across inputs)
    order = _contig_order(args.inputs[0])
    if order is None:
        print(
            f"{args.inputs[0]}: cannot read header (VCF text or BCF "
            "expected)",
            file=sys.stderr,
        )
        return 1
    # order inputs by their first record's contig rank
    rank = {n: i for i, n in enumerate(order)}
    keyed = sorted(
        args.inputs, key=lambda p2: _first_rank(p2, rank)
    )
    concat_vcfs(
        keyed, args.output, contig_order=order, out_file_type=ft,
        threads=max(0, args.threads),
    )
    return 0


def _kind(path):
    """'bcf' | 'vcf' | None, looking through gzip/BGZF compression."""
    try:
        with _open_auto(path) as f:
            head = f.read(5)
    except OSError:
        return None
    if head == b"BCF\x02\x02":
        return "bcf"
    if head[:2] == b"##":
        return "vcf"
    return None


def _contig_order(path):
    import struct

    with _open_auto(path) as f:
        head = f.read(5)
        f.seek(0)
        if head == b"BCF\x02\x02":
            f.seek(5)
            (l_text,) = struct.unpack("<I", f.read(4))
            text = f.read(l_text).rstrip(b"\x00").decode()
        elif head[:2] == b"##":
            text = ""
            for line in f:
                if not line.startswith(b"#"):
                    break
                text += line.decode()
        else:
            return None
    order = []
    for line in text.splitlines():
        if line.startswith("##contig=<ID="):
            order.append(line.split("ID=", 1)[1].split(",", 1)[0].rstrip(">"))
    return order


def _first_rank(path, rank):
    import struct

    with _open_auto(path) as f:
        head = f.read(5)
        f.seek(0)
        if head == b"BCF\x02\x02":
            f.seek(5)
            (l_text,) = struct.unpack("<I", f.read(4))
            f.seek(l_text, 1)
            sizes = f.read(8)
            if len(sizes) < 8:
                return 1 << 30
            body = f.read(8)
            if len(body) < 4:
                return 1 << 30
            (rid,) = struct.unpack_from("<i", body, 0)
            return rid
        for line in f:
            if line.startswith(b"#"):
                continue
            return rank.get(line.split(b"\t", 1)[0].decode(), 1 << 30)
    return 1 << 30


if __name__ == "__main__":
    sys.exit(main())
