"""Model stack: SigLIP tower, seq_mlp projector, Qwen2 LM, grounding model."""
