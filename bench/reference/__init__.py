"""The plain reference of LM training: fp32 PyTorch with TF32 off, written
anew from the published descriptions and the configuration files.  It
imports nothing of the port and takes nothing the port made: the
benchmark draws the weights and the batches and hands the same to both
sides.  ``common`` holds the embedding, the head's cross-entropy over the
padded vocabulary, the norms, RoPE and AdamW; ``<block_pattern>.py`` holds
a pattern's parameters (``leaves``) and its block (``block``)."""
