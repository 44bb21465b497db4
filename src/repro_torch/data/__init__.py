from repro_torch.data.pipeline import DataConfig, make_batch_fn, sample_tokens

__all__ = ["DataConfig", "make_batch_fn", "sample_tokens"]
