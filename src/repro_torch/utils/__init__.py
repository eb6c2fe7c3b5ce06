from repro_torch.utils.log import get_logger
from repro_torch.utils.tree import tree_norm
