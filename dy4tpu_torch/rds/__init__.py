"""RDS/RBDS digital data chain: channel coding, clock/data recovery,
Manchester + differential decoding, frame synchronisation, application
layer."""
from dy4tpu_torch.rds import coding  # noqa: F401
