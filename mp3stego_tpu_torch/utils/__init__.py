"""Shared utilities: WAV I/O, stage timers, tracing."""
