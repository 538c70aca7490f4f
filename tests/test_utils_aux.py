"""Tests for auxiliary utilities: chordal completion, stats, environments."""

import numpy as np
import pytest

from graphik_tpu.utils import chordal, environments, stats


class TestChordal:
    def _is_chordal(self, adj):
        """Brute-force chordality check: every cycle >= 4 has a chord."""
        N = adj.shape[0]
        # check all 4-cycles without chords
        for a in range(N):
            for b in range(N):
                if not adj[a, b]:
                    continue
                for c in range(N):
                    if c in (a, b) or not adj[b, c] or adj[a, c]:
                        continue
                    for d in range(N):
                        if d in (a, b, c):
                            continue
                        if adj[c, d] and adj[d, a] and not adj[b, d]:
                            return False
        return True

    def test_cycle_gets_filled(self):
        # 5-cycle: needs 2 fill edges
        N = 5
        adj = np.zeros((N, N), dtype=bool)
        for i in range(N):
            adj[i, (i + 1) % N] = adj[(i + 1) % N, i] = True
        chordal_adj, order = chordal.complete_to_chordal(adj)
        assert self._is_chordal(chordal_adj)
        assert chordal_adj.sum() > adj.sum()

    def test_already_chordal_unchanged(self):
        # a tree is chordal: no fill edges
        N = 6
        adj = np.zeros((N, N), dtype=bool)
        for i in range(1, N):
            p = (i - 1) // 2
            adj[i, p] = adj[p, i] = True
        chordal_adj, _ = chordal.complete_to_chordal(adj)
        np.testing.assert_array_equal(chordal_adj, adj)

    def test_cliques_cover_edges(self):
        rng = np.random.RandomState(0)
        N = 8
        adj = rng.rand(N, N) < 0.3
        adj = np.triu(adj, 1)
        adj = adj | adj.T
        cliques = chordal.chordal_cliques(adj)
        for i in range(N):
            for j in range(i + 1, N):
                if adj[i, j]:
                    assert any(i in c and j in c for c in cliques)


class TestStats:
    def test_normal_approximation(self):
        p, rad = stats.bernoulli_confidence_normal_approximation(100, 90)
        assert p == pytest.approx(0.9)
        assert 0.05 < rad < 0.07  # z=1.96 * sqrt(0.09/100) ~ 0.059

    def test_wilson(self):
        lo, hi = stats.wilson(100, 90)
        assert 0.8 < lo < 0.9 < hi < 1.0

    def test_jeffreys(self):
        p, rad = stats.bernoulli_confidence_jeffreys(100, 99)
        assert 0.9 < p < 1.0
        assert 0.0 < rad < 0.05

    def test_ndtri(self):
        assert stats._ndtri(0.975) == pytest.approx(1.959964, abs=1e-4)
        assert stats._ndtri(0.5) == pytest.approx(0.0, abs=1e-9)


class TestEnvironments:
    def test_table_environment(self):
        obs = environments.table_environment()
        assert len(obs) == 100  # 64 tabletop + 4*9 legs
        for center, radius in obs:
            assert center.shape == (3,)
            assert radius > 0


class TestVisualization:
    def test_visualize_scene_renders(self, tmp_path):
        """Mesh-free scene render (urdf_visualization.py:158-177 analogue)."""
        import numpy as np

        from graphik_tpu.graphs.problem import ProblemStructure
        from graphik_tpu.robots.library import load_ur10
        from graphik_tpu.utils import visualization as viz

        tpl, _ = load_ur10()
        ps = ProblemStructure.from_template(
            tpl, obstacles=[(np.array([0.5, 0.5, 0.5]), 0.2)]
        )
        ax = viz.visualize(
            ps, np.zeros(6), T_goal=np.eye(4), points=np.zeros((3, 3))
        )
        out = tmp_path / "scene.png"
        ax.figure.savefig(out)
        assert out.stat().st_size > 10_000

    def test_export_scene_obj(self, tmp_path):
        """Triangle-mesh scene export (the pyrender/trimesh analogue,
        urdf_visualization.py:9-60): valid OBJ with link cylinders,
        obstacle spheres, and goal-axis rods."""
        import numpy as np

        from graphik_tpu.graphs.problem import ProblemStructure
        from graphik_tpu.robots.library import load_ur10
        from graphik_tpu.utils import visualization as viz

        tpl, _ = load_ur10()
        ps = ProblemStructure.from_template(
            tpl, obstacles=[(np.array([0.5, 0.5, 0.5]), 0.2)]
        )
        out = tmp_path / "scene.obj"
        n_v, n_f = viz.export_scene_obj(
            ps, np.zeros(6), str(out), T_goal=np.eye(4)
        )
        assert n_v > 100 and n_f > 100
        verts, faces, objects = [], [], 0
        for line in open(out):
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:]])
            elif line.startswith("f "):
                faces.append([int(x) for x in line.split()[1:]])
            elif line.startswith("o "):
                objects += 1
        assert len(verts) == n_v and len(faces) == n_f
        # every face references a valid 1-based vertex
        fa = np.asarray(faces)
        assert fa.min() >= 1 and fa.max() <= n_v
        # 6 links + 1 obstacle + 3 goal axes
        assert objects == 6 + 1 + 3
        # obstacle sphere vertices sit on the sphere
        va = np.asarray(verts)
        d = np.linalg.norm(va - np.array([0.5, 0.5, 0.5]), axis=1)
        on_sphere = np.isclose(d, 0.2, atol=1e-6).sum()
        assert on_sphere >= 100  # the sphere's vertex budget


class TestMeshLoading:
    """Mesh-file loading for the scene export (the last pyrender-parity
    gap: urdf_visualization.py consumes URDF mesh files via trimesh)."""

    def _write_cube_obj(self, path):
        v = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
             (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
        # quad faces with v/vt/vn tokens: exercises fan-triangulation
        quads = [(1, 2, 3, 4), (5, 6, 7, 8), (1, 2, 6, 5),
                 (2, 3, 7, 6), (3, 4, 8, 7), (4, 1, 5, 8)]
        with open(path, "w") as f:
            for x in v:
                f.write(f"v {x[0]} {x[1]} {x[2]}\n")
            for q in quads:
                f.write("f " + " ".join(f"{i}//1" for i in q) + "\n")

    def _write_binary_stl(self, path):
        import struct

        tris = np.asarray([
            [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
            [[0, 0, 0], [0, 1, 0], [0, 0, 1]],
        ], np.float32)
        with open(path, "wb") as f:
            f.write(b"\0" * 80)
            f.write(struct.pack("<I", len(tris)))
            for t in tris:
                f.write(struct.pack("<3f", 0, 0, 1))
                for vert in t:
                    f.write(struct.pack("<3f", *vert))
                f.write(struct.pack("<H", 0))

    def test_load_obj_quads(self, tmp_path):
        from graphik_tpu.utils import visualization as viz

        p = tmp_path / "cube.obj"
        self._write_cube_obj(p)
        verts, faces = viz.load_mesh(str(p))
        assert verts.shape == (8, 3)
        assert faces.shape == (12, 3)  # 6 quads fan-split into 12 tris
        assert faces.min() >= 0 and faces.max() <= 7

    def test_load_binary_stl(self, tmp_path):
        from graphik_tpu.utils import visualization as viz

        p = tmp_path / "tri.stl"
        self._write_binary_stl(p)
        verts, faces = viz.load_mesh(str(p))
        assert verts.shape == (6, 3)
        assert faces.shape == (2, 3)
        np.testing.assert_allclose(verts[1], [1, 0, 0])

    def test_export_with_link_meshes(self, tmp_path):
        """A link with a mesh file replaces its cylinder and is posed in
        the link's world frame."""
        from graphik_tpu.graphs.problem import ProblemStructure
        from graphik_tpu.robots import kinematics
        from graphik_tpu.robots.library import load_ur10
        from graphik_tpu.utils import visualization as viz

        tpl, _ = load_ur10()
        ps = ProblemStructure.from_template(tpl)
        mesh = tmp_path / "cube.obj"
        self._write_cube_obj(mesh)
        out = tmp_path / "scene.obj"
        q = np.zeros(6)
        viz.export_scene_obj(
            ps, q, str(out), link_meshes={3: str(mesh)}
        )
        text = open(out).read()
        assert "_mesh" in text
        # the mesh's first vertex (local origin) must land at link 3's
        # world position
        T_all = np.asarray(kinematics.all_poses(tpl, q))
        lines = text.splitlines()
        start = lines.index(
            next(l for l in lines if l.startswith("o ") and "_mesh" in l)
        )
        first_v = next(
            l for l in lines[start:] if l.startswith("v ")
        ).split()[1:]
        np.testing.assert_allclose(
            [float(x) for x in first_v], T_all[3, :3, 3], atol=1e-5
        )


class TestCacheDir:
    """ensure_cache_dir ISA-stamping (utils/cache.py): never adopt unmarked
    entries, never delete a directory we did not stamp."""

    def test_fresh_dir_stamped_and_reused(self, tmp_path):
        from graphik_tpu.utils import cache

        p = str(tmp_path / "cache")
        got = cache.ensure_cache_dir(p)
        assert got == p
        marker = tmp_path / "cache" / cache._MARKER
        assert marker.exists()
        (tmp_path / "cache" / "entry").write_text("x")
        assert cache.ensure_cache_dir(p) == p
        assert (tmp_path / "cache" / "entry").exists()  # same sig: kept

    def test_stale_own_marker_wipes_in_place(self, tmp_path):
        from graphik_tpu.utils import cache

        p = tmp_path / "cache"
        p.mkdir()
        (p / cache._MARKER).write_text("not-this-host")
        (p / "stale_entry").write_text("x")
        got = cache.ensure_cache_dir(str(p))
        assert got == str(p)
        assert not (p / "stale_entry").exists()
        assert (p / cache._MARKER).read_text() == cache._host_signature()

    def test_foreign_dir_left_untouched(self, tmp_path):
        from graphik_tpu.utils import cache

        p = tmp_path / "shared"
        p.mkdir()
        (p / "precious").write_text("do not delete")
        got = cache.ensure_cache_dir(str(p))
        assert got != str(p) and got.startswith(str(p))  # redirected
        assert (p / "precious").read_text() == "do not delete"
        import os

        assert os.path.exists(os.path.join(got, cache._MARKER))
        # second call resolves to the same stamped subdir
        assert cache.ensure_cache_dir(str(p)) == got

    def test_env_var_is_the_only_cache(self, tmp_path, monkeypatch):
        """With JAX_COMPILATION_CACHE_DIR set, that directory is used as
        is: not stamped, not redirected, and no other directory is made."""
        from graphik_tpu.utils import cache

        env = tmp_path / "from_env"
        monkeypatch.setenv(cache.ENV_VAR, str(env))
        monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / "default"))
        assert cache.cache_dir() == str(env)
        assert not env.exists()
        assert not (tmp_path / "default").exists()

    def test_default_is_fixed_in_checkout(self, tmp_path, monkeypatch):
        """Without the variable, the cache is one fixed directory inside
        the checkout that .gitignore lists, stable across calls."""
        import os

        from graphik_tpu.utils import cache

        monkeypatch.delenv(cache.ENV_VAR, raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
        monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / "c"))
        first = cache.cache_dir()
        assert first == str(tmp_path / "c")
        assert cache.cache_dir() == first
