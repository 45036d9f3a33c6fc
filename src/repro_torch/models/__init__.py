"""Models of the port: the dense transformer, GCN, ssm (rwkv6) and hybrid
(hymba) families, and the family registry."""
