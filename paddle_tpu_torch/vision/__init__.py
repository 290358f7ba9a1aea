"""Vision models of the port (port of paddle_tpu/vision)."""
