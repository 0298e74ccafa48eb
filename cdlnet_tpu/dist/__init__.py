from cdlnet_tpu.dist.mesh import make_mesh
from cdlnet_tpu.dist.sharding import (
    batch_sharding,
    replicate_sharding,
    make_dp_train_step,
    subband_shardings,
)
from cdlnet_tpu.dist.halo import halo_exchange, sharded_lista_3d_forward
from cdlnet_tpu.dist.init import initialize_distributed
