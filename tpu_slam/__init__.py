"""tpu_slam — 2D laser SLAM as JAX/XLA device programs."""
