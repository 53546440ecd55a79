"""Command line of the PyTorch port: the flags of `bs_call_tpu.cli`, with
`--device {cuda,cpu}` (default cuda).

`--device cuda` runs the device tiers on the GPU through the hand-written
kernels and raises when PyTorch sees no CUDA device; `--device cpu` runs
their plain PyTorch versions. Output bytes equal those of
`python -m bs_call_tpu.cli --device cpu` on the same input and flags.

Run as `python -m bs_call_tpu_torch.cli in.bam -r ref.fa -o out.vcf ...`.
"""

from __future__ import annotations

import sys

from bs_call_tpu.cli import args_to_config, build_parser
from bs_call_tpu_torch.device import DEVICES, resolve_device


def build_torch_parser():
    p = build_parser()
    p.prog = "bs_call_torch"
    dev = p._option_string_actions["--device"]
    dev.choices = list(DEVICES)
    dev.default = "cuda"
    dev.help = (
        "cuda: device tiers on the GPU through the CUDA kernels (raises "
        "without one); cpu: their plain PyTorch versions"
    )
    return p


def main(argv=None, tracer=None):
    """CLI entry. `tracer` (a `bs_call_tpu.utils.trace.Tracer`), when
    given, collects stage times and per-tier position counts."""
    args = build_torch_parser().parse_args(argv)
    if (args.shards and args.shards > 1) or (
        args.num_hosts and args.num_hosts > 1
    ):
        print(
            "bs_call_torch: --shards and --num-hosts are not yet ported "
            "to bs_call_tpu_torch; run a single process",
            file=sys.stderr,
        )
        return 2
    if not args.reference:
        print(
            "Error in bs_call: a sequence archive is mandatory",
            file=sys.stderr,
        )
        return 1
    device = resolve_device(args.device)
    if not args.input_file:
        args.input_file = "-"
    cfg = args_to_config(args)
    stats = None
    if cfg.report_file:
        from bs_call_tpu.stats.collect import BsStats

        stats = BsStats()
    from bs_call_tpu_torch.pipeline.runner import run_caller

    try:
        stats, table = run_caller(cfg, device, stats=stats, tracer=tracer)
    except BrokenPipeError:
        # downstream consumer (e.g. `| head`) closed the pipe: exit
        # quietly like a SIGPIPE'd C tool
        import os

        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        return 0
    if cfg.report_file and stats is not None:
        from bs_call_tpu.stats.report import write_report

        with open(cfg.report_file, "w") as f:
            write_report(f, cfg, stats, table, dbsnp=cfg.dbsnp_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
