from koordinator_tpu_torch.harness import generators  # noqa: F401
