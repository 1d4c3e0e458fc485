from semi_pd_tpu_torch.config.model_config import ModelConfig
from semi_pd_tpu_torch.config.server_args import ServerArgs

__all__ = ["ModelConfig", "ServerArgs"]
