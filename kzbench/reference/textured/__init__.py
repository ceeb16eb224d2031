"""The reference of the Textured configuration (kazen-con-1's whole
pipeline): ``kz/`` and ``con1/`` (the normal map) with what Textured adds
to them, the Beckmann lobes of roughconductor, roughplastic and
roughdielectric, the importance-sampled environment as a NEE stratum with
both MIS weights, and the gaussian film filter. Each module here is a
frozen copy of the part of the program's plain path it names, and imports
nothing of the program."""
