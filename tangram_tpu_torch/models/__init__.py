from .mapper import Mapper, MapperConstrained, fit_mapping, init_logits

__all__ = ["Mapper", "MapperConstrained", "fit_mapping", "init_logits"]
