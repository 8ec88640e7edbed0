"""Walkthroughs of the package's user journeys, each runnable with
``python -m fbtt_embedding_tpu_torch.examples.<name>``."""
