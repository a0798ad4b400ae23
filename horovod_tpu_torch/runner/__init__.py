"""The port's launcher (``hvdrun``) and rendezvous store — counterpart of
``horovod_tpu/runner``. ``run`` and ``run_commandline`` load lazily, so
importing the package stays cheap."""

__all__ = ["run", "run_commandline"]


def __getattr__(name):
    if name in __all__:
        from . import launch

        return getattr(launch, name)
    raise AttributeError(name)
