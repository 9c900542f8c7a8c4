"""The training plane: data, AdamW, int8 gradient compression, checkpoints,
fault tolerance and the LoRA fine-tune step (one device, or data-parallel
over a process mesh's axis); the sharded full-parameter step is
``distributed.steps.make_train_step``."""
