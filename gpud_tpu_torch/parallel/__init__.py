"""The port's analytics over a device mesh: ``fleet`` (the sharded link
scan, scores and dp×tp training step on ``torch.distributed``)."""
