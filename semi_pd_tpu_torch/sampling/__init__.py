from semi_pd_tpu_torch.sampling.sampling_params import SamplingParams

__all__ = ["SamplingParams"]
