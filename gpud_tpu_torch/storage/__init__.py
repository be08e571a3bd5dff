"""Write-behind storage layer: batched, group-commit SQLite ingest.

``BatchWriter`` (gpud_tpu_torch/storage/writer.py, the port of
``gpud_tpu/storage/writer.py``) is the single commit path
all four persistent stores (metrics time-series, eventstore, health
ledger, remediation audit) route their hot-path writes through when
``Config.storage_batch_enabled`` is on. See docs/storage.md.
"""

from gpud_tpu_torch.storage.writer import BatchWriter, checkpoint_wal

__all__ = ["BatchWriter", "checkpoint_wal"]
