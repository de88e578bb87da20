"""Operations and bytes of the kernels and models the cells run, counted from
shapes and from the entries a view needs, never from a table's capacity."""
