"""Host utilities: metrics and timers, the wire format (serde), network
addresses (address), and the warmup of device shapes (warmup)."""
