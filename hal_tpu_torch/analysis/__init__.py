"""Port copy of hal_tpu/analysis/__init__.py (numpy only; the same code,
imports pointing at hal_tpu_torch).

Analysis pipelines (reference analysis/: neutral-indel conservation,
constraint turnover, synteny rates, contiguous regions).

The reference shells out to BedTools (sortBed/mergeBed/intersectBed/
subtractBed — analysis/neutralIndel/turnoverRate.py:52-69); here the interval
algebra is vectorized numpy (`hal_tpu_torch.analysis.intervals`) so the
pipelines are self-contained and array-native.
"""
