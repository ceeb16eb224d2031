"""Scene builders: ``build(D, config) -> D.Scene`` per module, where ``D`` is
a scene-description module (the program's ``scene.description`` or the
reference's frozen copy) and ``config`` the configuration's JSON."""
