from multimodalfusion_tpu_torch.extract.features import Embedder  # noqa: F401
