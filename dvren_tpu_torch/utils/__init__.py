"""Small helpers: :func:`~dvren_tpu_torch.utils.pytree.device_put_tree`."""
