from .loader import ConfigNode, load_config, make_run_dir

__all__ = ["ConfigNode", "load_config", "make_run_dir"]
