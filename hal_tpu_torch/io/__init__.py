"""Port copy of hal_tpu/io/__init__.py (numpy only; the same code, imports
pointing at hal_tpu_torch).

Text-format I/O: BED, PSL, MAF, wiggle, FASTA parsers/writers.

All emission is byte-compatible with the reference tools' output
(SURVEY.md §7.2 item 6: exact host-side formatting over device-produced
sorted integer block arrays)."""
