from repro_torch.data.pipeline import DataConfig, TokenStream

__all__ = ["DataConfig", "TokenStream"]
