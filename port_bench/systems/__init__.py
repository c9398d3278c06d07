"""One module a kind of configuration (``harness.Cell.system``), whose
``System(cfg, mix, seed, device)`` drives the port for it and holds its
check against the reference:

  - ``start(schedule)``, ``dispatch(i)``, ``stop()``: the program's
    set-up, request i, and dropping its state;
  - ``items``, ``launched``: work items a request, and the port's kernels
    a request must launch (``_build.launches``);
  - ``check(outputs)``: the kept outputs {input set: [outputs]} against
    the reference, as ({number: (value, limit, what)}, outputs wrong);
  - ``control_outputs(sets, rounds)``: the control's outputs, the
    reference with a PRG of ``rounds`` rounds in the program's place.
"""
