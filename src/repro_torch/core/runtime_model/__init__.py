"""The DMM runtime model: generative model, amortized guide, and the
``RuntimeModel`` API (ELBO fit, prediction, the fused decision)."""
