"""Training runtime of the port: the trainer, its checkpoints, and the
reader of reference ``.pt`` files."""
from .pt_loader import flatten_state_dict, load_pt  # noqa: F401
