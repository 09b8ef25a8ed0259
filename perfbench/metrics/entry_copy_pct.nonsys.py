"""entry_copy_pct.nonsys: the device time of the work launched inside the
frame-major decode entry's copies (the program's spans
``decode.transpose_in`` and ``decode.transpose_out``) in the
non-systematic campaign's steps, as a share of the card's busy time in the
traced window (%): ``entry_copy_pct.decode``'s reading in another cell."""

from pathlib import Path

from harness import _load_module

read = _load_module(Path(__file__).with_name("entry_copy_pct.decode.py")).read
