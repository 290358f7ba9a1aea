"""``paddle.distributed.fleet`` of the port: only ``fleet.utils`` (the
user-facing ``recompute``) so far."""
