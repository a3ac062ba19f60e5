"""Table-backed approximate numerics (twin of ``repro/numerics``)."""
from repro_torch.numerics.ops import (BACKENDS, ExactNumerics,  # noqa: F401
                                      InterpNumerics, approx_exp_neg,
                                      approx_gelu, approx_recip_pos,
                                      approx_rmsnorm, approx_rsqrt_pos,
                                      approx_sigmoid, approx_silu,
                                      approx_softmax, approx_softplus,
                                      get_numerics, softmax_ulp_bound,
                                      table_eval_int)
from repro_torch.numerics.guard import (DomainViolation,  # noqa: F401
                                        GuardedNumerics)
from repro_torch.numerics.registry import get_table, spec_for  # noqa: F401
