"""The dense decoder-only transformer LM of the port (prefill and decode)."""
