"""``bench/calibrate.py`` with one variant more, for a cell of one row:

    python bench/calibrate_row.py --workload <cell> --control-seeds 4,5 \
        --variants fp8,half_row,token_altered

* ``half_row``: the first half of each row, its tokens and its labels (the
  mean over the rest), where ``half_batch`` leaves no row at a batch of one.

Every other variant and option is ``calibrate.py``'s.  The benchmark's own
runs never run this.
"""
import sys

import calibrate

_variant_batches = calibrate.variant_batches


def variant_batches(first: list, variant: str, vocab: int) -> list:
    if variant == "half_row":
        half = first[0]["tokens"].shape[1] // 2
        return [{k: v[:, :half].contiguous() for k, v in b.items()} for b in first]
    return _variant_batches(first, variant, vocab)


calibrate.variant_batches = variant_batches

if __name__ == "__main__":
    sys.exit(calibrate.main())
