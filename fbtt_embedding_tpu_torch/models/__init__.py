"""Subpackage of fbtt_embedding_tpu_torch."""
