"""The training plane: data, AdamW, int8 gradient compression, checkpoints,
fault tolerance and the LoRA fine-tune step (single device; the
collective-bearing SPMD steps are ROADMAP A8b)."""
