"""Model layer: the functional Llama, sampling, tokenizers, the generation
engine and the bridge from the JAX package's parameter tree."""
