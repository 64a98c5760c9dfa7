"""The mesh of the port: a (data, model) ``torch.distributed`` mesh
(``mesh``), a launcher for its ranks on one host (``local``) and the
distributed scoring, search and cascade steps (``search``)."""
