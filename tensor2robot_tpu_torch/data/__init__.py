"""Input generators: batched numpy data streams shaped by a model's specs."""
