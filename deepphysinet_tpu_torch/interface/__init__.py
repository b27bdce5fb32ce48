from deepphysinet_tpu_torch.interface.build import builder_models
from deepphysinet_tpu_torch.interface.interface_physics import InterfacePhysics

__all__ = ["builder_models", "InterfacePhysics"]
