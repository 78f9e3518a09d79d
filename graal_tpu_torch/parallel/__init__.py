"""Multi-chain samplers of the port (chains batched on one device)."""
