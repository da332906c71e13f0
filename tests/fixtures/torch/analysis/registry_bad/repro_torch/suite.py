"""Violating twin: every registry-conformance failure mode at once."""


def register_workload(name, **kw):
    def deco(fn):
        return fn
    return deco


def register_backend(name=None, **kw):
    def deco(cls):
        return cls
    return deco


@register_workload("dup", backends=("sim",))
def build_dup(params, backend):
    return params, backend


@register_workload("dup", backends=("sim",))  # duplicate name: silent win
def build_dup_again(params, backend):
    return params, backend


@register_workload("solo", aliases=("dup",), backends=("sim",))
def build_solo(params, backend):  # alias shadows an existing name
    return params, backend


@register_workload("narity")  # no backends: unreachable in campaigns
def build_narity(params, backend, arch):  # 3 required positionals
    return params, backend, arch


@register_backend()  # no literal name anywhere
class Nameless:
    mode = "cache"

    def run(self, workload, **cfg):
        return workload


@register_backend("sim", aliases=("fast",))
class Sim:
    mode = "cache"

    def run(self, workload, **cfg):
        return workload


@register_backend("sim")  # duplicate registry name
class SimAgain:  # and neither run() nor mode
    def configure(self):
        return None


def register_device_family(name, **kw):
    def deco(fn):
        return fn
    return deco


@register_device_family("cell")
def build_cell(params):
    return params


@register_device_family("cell")  # duplicate family name
def build_cell_again(params):
    return params


@register_device_family("other", aliases=("cell",))  # alias shadows name
def build_other(params, extra):  # 2 required positionals: builder(params)
    return params, extra
