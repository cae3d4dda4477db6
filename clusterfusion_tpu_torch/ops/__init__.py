"""Op layer: the hand-written Hopper kernels with their plain PyTorch twins,
and the small plain helpers around them."""
