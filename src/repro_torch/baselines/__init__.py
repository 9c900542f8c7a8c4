"""Baselines the paper compares against (S-LoRA presets of the simulator)."""
