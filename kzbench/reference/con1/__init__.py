"""The reference of BASELINE's configuration 3 (kazen-con-1): the frozen
``kz/`` copy of the program's plain path, with what configuration 3 adds to
it, the thin-lens camera and the normal-map shading frame. Modules of
``kz/`` that need no change are imported as they are; each module here is a
frozen copy of the part of the program's plain path it names, and imports
nothing of the program."""
