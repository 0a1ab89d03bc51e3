from multimodalfusion_tpu_torch.interpret.ig import integrated_gradients  # noqa: F401
