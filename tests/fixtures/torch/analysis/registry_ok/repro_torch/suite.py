"""Clean twin: conforming registrations, including the factory idiom."""


def register_workload(name, **kw):
    def deco(fn):
        return fn
    return deco


def register_backend(name=None, **kw):
    def deco(cls):
        return cls
    return deco


@register_workload("alpha", backends=("sim",))
def build_alpha(params, backend):
    return params, backend


@register_workload("beta", aliases=("b",), backends=("sim",))
def build_beta(params, backend, _arch="tiny"):  # closure capture: default
    return params, backend, _arch


def _register_family(arch):
    # dynamic names skip the literal uniqueness checks by design
    @register_workload(arch, backends=("sim",))
    def _build(params, backend, _arch=arch):
        return params, backend, _arch
    return _build


@register_backend("sim", aliases=("fast",))
class Sim:
    mode = "cache"

    def run(self, workload, **cfg):
        return workload


def register_device_family(name, **kw):
    def deco(fn):
        return fn
    return deco


@register_device_family("cell", aliases=("gc",))
def build_cell(params):
    return params


def _register_cell_variant(flavor):
    # dynamic names skip the literal uniqueness checks by design
    @register_device_family(flavor)
    def _build(params, _flavor=flavor):  # closure capture: default
        return params, _flavor
    return _build
