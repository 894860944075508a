"""JAX train steps compiled once, at XLA's backend optimisation level 1.

`compile_once(step)` wraps a jitted JAX function (a `make_*_train_step`
step): its first call lowers and compiles it for those arguments with
`xla_backend_optimization_level` 1, and every call runs that executable.
On the CPU this compiles the tiny models' train steps markedly faster
than the default level (`test_torch_train.py` alone: 196 s -> 139 s;
`test_torch_ddp.py`: ~95 s at the default); level 0 gave NaN gradients
in some steps.  An eval forward gains ~5% at level 0 (RPVNet's four
logits cases 91 s -> 86 s), so the forwards keep the default.  The
arguments of later calls must have the first call's shapes and dtypes.
"""


def compile_once(step):
    compiled = None

    def call(*args):
        nonlocal compiled
        if compiled is None:
            compiled = step.lower(*args).compile(compiler_options={"xla_backend_optimization_level": 1})
        return compiled(*args)

    return call
