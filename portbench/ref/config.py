"""Runtime configuration (the reference's sr_param, bs_call.h:295-332)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from portbench.ref import constants as C


@dataclass
class CallerConfig:
    input_file: Optional[str] = None
    reference_file: Optional[str] = None
    output_file: Optional[str] = None
    sample_name: Optional[str] = None
    dbsnp_file: Optional[str] = None
    report_file: Optional[str] = None
    contig_bed: Optional[str] = None
    contig_sizes: Optional[str] = None

    keep_duplicates: bool = False
    ignore_duplicates: bool = False
    keep_unmatched: bool = False
    haploid: bool = False          # accepted for CLI parity; unused upstream too
    blank_trim: bool = False       # accepted for CLI parity; unused upstream too
    all_positions: bool = False
    benchmark_mode: bool = False
    out_file_type: int = C.FT_UNKN

    left_trim: Tuple[int, int] = (0, 0)
    right_trim: Tuple[int, int] = (0, 0)
    mapq_thresh: int = C.DEFAULT_MAPQ_THRESH
    min_qual: int = C.MIN_QUAL
    max_template_len: int = C.DEFAULT_MAX_TEMPLATE_LEN
    under_conv: float = C.DEFAULT_UNDER_CONVERSION
    over_conv: float = C.DEFAULT_OVER_CONVERSION
    ref_bias: float = C.DEFAULT_REF_BIAS

    # engine knobs (the device is run_caller's argument, not a field)
    threads: int = 4               # calc share of -t (see input/output below)
    # -t calc,input,output explicit split (parse_args.c:144-146); when
    # None the runner derives pools from `threads` (the 4:3:3 auto-split
    # of parse_args.c:194-213 happens in cli.args_to_config)
    input_threads: Optional[int] = None   # ingest inflate pool size
    output_threads: Optional[int] = None  # BGZF deflate pool size
    verbose: bool = False
    exact: bool = True             # run the float64 libm rescue pass
    reference_quirks: bool = True  # reproduce benign reference bugs for parity
    # engine batch / emit-stream chunk size (padded to one compiled
    # shape). Swept on the 4-core host: 16k/32k ≈ 122k reads/s, 64k 102k,
    # 128k 61k (bigger chunks starve the call/emit overlap)
    batch_positions: int = 1 << 15

    def sanitize(self):
        mq = self.min_qual
        if mq < 1:
            mq = 1
        elif mq > C.MAX_QUAL:
            mq = C.MAX_QUAL
        self.min_qual = mq
        return self
