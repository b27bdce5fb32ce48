from deepphysinet_tpu_torch.config.config import Config, load_config, update_params

__all__ = ["Config", "load_config", "update_params"]
