from .attention import attention_tables, get_network_weight
from .network import generate_viz, get_local_interpretation
