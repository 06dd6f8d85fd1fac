"""checkpoint of the PyTorch port (the straggler rule the engine's step
watchdog shares with training)."""
