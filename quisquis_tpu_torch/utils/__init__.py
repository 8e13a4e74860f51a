"""Host utilities: metrics and timers."""
