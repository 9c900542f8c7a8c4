"""Adapters, the LoRA Server and the disaggregated decode step."""
