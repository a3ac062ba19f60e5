from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: F401
                                     adamw_state_shapes, adamw_update,
                                     global_norm)
from repro_torch.optim.compress import (compress_grads,  # noqa: F401
                                        compress_init, compress_state_shapes,
                                        decompress_grads)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
