"""Model math of the port: layers, MoE, the paged cache and parameters."""
