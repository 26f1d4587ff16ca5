from .rdf_gen import (lubm_like, dblp_like, imdb_like, sp2b_like,
                      random_graph, DATASETS)
from .queries import random_query, generalize_literal, keyword_for_node
from .lm_data import TokenPipeline
