"""AdamW and learning-rate schedules (counterpart of ``repro.optim``; the
gradient compression of ``optim/compress.py`` waits for ROADMAP A14)."""
