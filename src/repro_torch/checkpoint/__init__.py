"""Checkpoints of the PyTorch port: npz shards and a JSON manifest, written
atomically, saved in the background, restored exactly."""
