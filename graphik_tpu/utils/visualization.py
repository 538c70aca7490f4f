"""Matplotlib visualization (reference utils/robot_visualization.py +
an OpenGL-free analogue of the pyrender scene viewer, urdf_visualization.py).

Plots planar manipulators, 3D point-graph realizations with frames, solved
robot scenes (link cylinders, joint frame triads, obstacle spheres, goal
frames), full URDF mesh scenes (make_scene + visualize_meshes, backed by
the io/mesh.py OBJ/STL/COLLADA loaders), and solver-metric histograms.
matplotlib is imported lazily so headless deployments don't pay for it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_planar_robot(ps, q, T_goal=None, ax=None, show_obstacles=True):
    """Draw a planar chain/tree at configuration q
    (robot_visualization.py:95-196)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    pos = np.asarray(ps.realization(np.asarray(q, dtype=float)))
    tpl = ps.template
    for i in range(1, tpl.n + 1):
        par = int(tpl.parents[i])
        ax.plot(
            [pos[par, 0], pos[i, 0]], [pos[par, 1], pos[i, 1]],
            "-o", color="tab:blue", markersize=4,
        )
    ax.plot(pos[0, 0], pos[0, 1], "ks", markersize=8)
    if T_goal is not None:
        Tg = np.asarray(T_goal)
        ax.plot(Tg[0, 2], Tg[1, 2], "r*", markersize=14)
    if show_obstacles:
        for center, radius in ps.obstacles:
            ax.add_patch(
                plt.Circle(center[:2], radius, color="tab:red", alpha=0.3)
            )
    ax.set_aspect("equal")
    return ax


def plot_revolute_points(ps, pos, ax=None, show_aux=True, show_obstacles=True):
    """3D scatter/segment plot of a solved point graph
    (robot_visualization.py:203-252)."""
    plt = _plt()
    if ax is None:
        fig = plt.figure(figsize=(7, 7))
        ax = fig.add_subplot(projection="3d")
    pos = np.asarray(pos)
    tpl = ps.template
    n = tpl.n
    for i in range(1, n + 1):
        par = int(tpl.parents[i])
        ax.plot(
            [pos[par, 0], pos[i, 0]],
            [pos[par, 1], pos[i, 1]],
            [pos[par, 2], pos[i, 2]],
            "-o", color="tab:blue",
        )
    if show_aux:
        for i in range(n + 1):
            p = pos[ps.idx_p(i)]
            qpt = pos[ps.idx_q(i)]
            ax.plot(
                [p[0], qpt[0]], [p[1], qpt[1]], [p[2], qpt[2]],
                "-", color="tab:green", alpha=0.5,
            )
    if show_obstacles:
        u, v = np.mgrid[0 : 2 * np.pi : 12j, 0 : np.pi : 8j]
        for center, radius in ps.obstacles:
            x = center[0] + radius * np.cos(u) * np.sin(v)
            y = center[1] + radius * np.sin(u) * np.sin(v)
            z = center[2] + radius * np.cos(v)
            ax.plot_wireframe(x, y, z, color="tab:red", alpha=0.2)
    return ax


def _frame_triad(ax, T, scale=0.12):
    """RGB axis triad at pose T (urdf_visualization.py frame markers)."""
    T = np.asarray(T)
    o = T[:3, 3]
    for k, color in enumerate(("r", "g", "b")):
        a = o + scale * T[:3, k]
        ax.plot([o[0], a[0]], [o[1], a[1]], [o[2], a[2]], color=color, lw=2)


def _cylinder(ax, p0, p1, radius, color, alpha=0.8, n_theta=10):
    """Link cylinder between two joint origins (replaces the reference's
    edge cylinders, urdf_visualization.py:123-156)."""
    p0 = np.asarray(p0, float)
    p1 = np.asarray(p1, float)
    axis = p1 - p0
    L = np.linalg.norm(axis)
    if L < 1e-9:
        return
    axis = axis / L
    # orthonormal frame around the axis
    ref = np.array([1.0, 0.0, 0.0])
    if abs(axis @ ref) > 0.9:
        ref = np.array([0.0, 1.0, 0.0])
    u = np.cross(axis, ref)
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    th = np.linspace(0, 2 * np.pi, n_theta)
    t = np.linspace(0, L, 2)
    th_g, t_g = np.meshgrid(th, t)
    pts = (
        p0[None, None, :]
        + t_g[..., None] * axis[None, None, :]
        + radius * np.cos(th_g)[..., None] * u[None, None, :]
        + radius * np.sin(th_g)[..., None] * v[None, None, :]
    )
    ax.plot_surface(
        pts[..., 0], pts[..., 1], pts[..., 2],
        color=color, alpha=alpha, linewidth=0,
    )


def visualize(ps, q, T_goal=None, points=None, ax=None, link_radius=0.025,
              show_frames=True, show_obstacles=True):
    """Render a solved 3D robot scene (urdf_visualization.py:158-177
    capability, mesh-free): link cylinders at configuration q, joint frame
    triads, obstacle spheres, goal frame(s), and optional solution points
    (e.g. the solver's Y) as red balls.

    Returns the 3D axes; call `.figure.savefig(...)` to export.
    """
    plt = _plt()
    if ax is None:
        fig = plt.figure(figsize=(7, 7))
        ax = fig.add_subplot(projection="3d")
    tpl = ps.template
    from graphik_tpu.robots import kinematics as _kin

    T_all = np.asarray(_kin.all_poses(tpl, np.asarray(q, dtype=float)))
    for i in range(1, tpl.n + 1):
        par = int(tpl.parents[i])
        _cylinder(
            ax, T_all[par, :3, 3], T_all[i, :3, 3], link_radius, "tab:blue"
        )
    if show_frames:
        for i in range(tpl.n + 1):
            _frame_triad(ax, T_all[i])
    if T_goal is not None:
        Tg = np.asarray(T_goal)
        if Tg.ndim == 2:
            Tg = Tg[None]
        for T in Tg:
            _frame_triad(ax, T, scale=0.18)
    if points is not None:
        pts = np.asarray(points)
        ax.scatter(
            pts[..., 0].ravel(), pts[..., 1].ravel(), pts[..., 2].ravel(),
            color="tab:red", s=25, alpha=0.8,
        )
    if show_obstacles:
        u, v = np.mgrid[0 : 2 * np.pi : 14j, 0 : np.pi : 10j]
        for center, radius in ps.obstacles:
            x = center[0] + radius * np.cos(u) * np.sin(v)
            y = center[1] + radius * np.sin(u) * np.sin(v)
            z = center[2] + radius * np.cos(v)
            ax.plot_surface(x, y, z, color="tab:red", alpha=0.25, linewidth=0)
    ax.set_box_aspect((1, 1, 1))
    return ax


def plot_solve_metrics(out, ax=None):
    """Histogram of per-instance pose errors from a batched solve result
    (the experiments' histogram plots, convex_iteration.py:424-473)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(1, 2, figsize=(10, 4))
    e_pos = np.ravel(np.asarray(out["e_pos"]))
    ax[0].hist(np.log10(np.maximum(e_pos, 1e-12)), bins=40, color="tab:blue")
    ax[0].set_xlabel("log10 position error")
    if "iterations" in out:
        ax[1].hist(np.ravel(np.asarray(out["iterations"])), bins=40, color="tab:orange")
        ax[1].set_xlabel("iterations")
    return ax


# ---------------------------------------------------------------------------
# Mesh export (the reference's pyrender/trimesh scene, urdf_visualization.py
# :9-60 and 158-177, as a dependency-free triangle-mesh writer: any mesh
# viewer replaces the pyrender window)
# ---------------------------------------------------------------------------

def _cylinder_mesh(p0, p1, radius, n_theta=16):
    """(vertices, faces) of a closed cylinder from p0 to p1.

    Posed wrapper around the single tessellator in io.mesh (z-axis
    cylinder centered at the origin): rotate local z onto p1-p0 and
    translate to the segment midpoint.
    """
    from graphik_tpu.io.mesh import cylinder_mesh

    p0 = np.asarray(p0, float)
    p1 = np.asarray(p1, float)
    axis = p1 - p0
    h = np.linalg.norm(axis)
    if h < 1e-12:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    v, f = cylinder_mesh(radius, h, n_theta=n_theta)
    w = axis / h
    u = np.cross(w, [0.0, 0.0, 1.0])
    if np.linalg.norm(u) < 1e-8:
        u = np.cross(w, [0.0, 1.0, 0.0])
    u /= np.linalg.norm(u)
    R = np.stack([u, np.cross(w, u), w], axis=1)  # columns: local x,y,z
    return v @ R.T + (p0 + p1) / 2.0, f


def _sphere_mesh(center, radius, n_theta=16, n_phi=12):
    """(vertices, faces) of a UV sphere at `center` (io.mesh tessellator)."""
    from graphik_tpu.io.mesh import sphere_mesh

    v, f = sphere_mesh(radius, n_theta=n_theta, n_phi=n_phi)
    return v + np.asarray(center, float), f


def load_mesh(path):
    """Load a triangle mesh (.obj / .stl / .dae) — see io/mesh.py.

    Kept as a re-export: this module's OBJ/STL loader moved to
    graphik_tpu.io.mesh when COLLADA support was added.
    """
    from graphik_tpu.io.mesh import load_mesh as _lm

    return _lm(path)


def make_scene(model, q=None, mesh_root=None, with_robot=True,
               with_frames=True, with_balls=True, with_edges=True,
               collision=False, frame_scale=0.13, ball_radius=0.02,
               edge_radius=0.005):
    """Assemble the full meshed robot scene as triangle-mesh groups.

    This framework's equivalent of the reference's pyrender scene builder
    (urdf_visualization.py:9-60 `make_scene`): URDF link visual meshes
    posed at configuration q, axis-triad frames and marker balls at every
    joint frame (the reference instances frame.dae / redball.dae,
    urdf_visualization.py:40-47 — ours are generated geometry, so no mesh
    assets are required), and gray cylinders between every joint-frame
    pair (urdf_visualization.py:49-59, incl. the <1 mm degenerate-edge
    skip). `model` is an io.urdf.UrdfModel; q is a template joint vector
    (mapped to URDF joints via cfg_from_q) or a {joint_name: angle} dict.

    Returns [(name, verts (V, 3), faces (F, 3))] — feed to
    visualize_meshes for a matplotlib rendering or write_obj for export.
    """
    from itertools import combinations

    from graphik_tpu.io.mesh import sphere_mesh

    cfg = None
    if q is not None:
        cfg = q if isinstance(q, dict) else model.cfg_from_q(q)
    groups = []
    if with_robot:
        for link, v, f in model.visual_meshes(
            cfg, mesh_root=mesh_root, collision=collision
        ):
            groups.append((f"link_{link}", v, f))

    _, T_frames = model.t_zero(cfg)
    Ts = list(T_frames.values())
    if with_frames:
        for k, T in enumerate(Ts):
            for a in range(3):
                v, f = _cylinder_mesh(
                    T[:3, 3], T[:3, 3] + frame_scale * T[:3, a],
                    edge_radius * 1.6, n_theta=8,
                )
                groups.append((f"frame_{k}_axis_{a}", v, f))
    if with_balls:
        for k, T in enumerate(Ts):
            v, f = sphere_mesh(ball_radius)
            groups.append((f"ball_{k}", v + T[:3, 3], f))
    if with_edges:
        for i, j in combinations(range(len(Ts)), r=2):
            p0, p1 = Ts[i][:3, 3], Ts[j][:3, 3]
            if np.linalg.norm(p1 - p0) < 1e-3:
                continue  # zero-height cylinder (urdf_visualization.py:80-82)
            v, f = _cylinder_mesh(p0, p1, edge_radius, n_theta=8)
            groups.append((f"edge_{i}_{j}", v, f))
    return groups


def visualize_meshes(groups, ax=None, max_faces=6000, elev=20.0,
                     azim=45.0, color="lightsteelblue"):
    """Render triangle-mesh groups with matplotlib (Poly3DCollection).

    The viewer half of the reference's pyrender pipeline
    (urdf_visualization.py:158-177) without an OpenGL dependency. Dense
    meshes are face-subsampled to max_faces total so interactive use stays
    responsive; pass max_faces=None for exact rendering.
    """
    plt = _plt()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if ax is None:
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
    total = sum(len(f) for _, _, f in groups) or 1
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for name, v, f in groups:
        if not len(f):
            continue
        if max_faces is not None and total > max_faces:
            keep = max(1, int(len(f) * max_faces / total))
            f = f[np.linspace(0, len(f) - 1, keep).astype(int)]
        tris = v[f]
        col = Poly3DCollection(
            tris, alpha=0.9 if name.startswith("link") else 0.7
        )
        col.set_facecolor(
            color if name.startswith("link")
            else ("tab:red" if name.startswith("ball") else "gray")
        )
        col.set_edgecolor("none")
        ax.add_collection3d(col)
        lo = np.minimum(lo, v.min(axis=0))
        hi = np.maximum(hi, v.max(axis=0))
    if np.all(np.isfinite(lo)):
        center = (lo + hi) / 2
        half = float((hi - lo).max()) / 2 or 1.0
        ax.set_xlim(center[0] - half, center[0] + half)
        ax.set_ylim(center[1] - half, center[1] + half)
        ax.set_zlim(center[2] - half, center[2] + half)
    ax.view_init(elev=elev, azim=azim)
    return ax


def write_obj(groups, path):
    """Write mesh groups as a Wavefront OBJ; returns (n_verts, n_faces)."""
    n_total = 0
    n_faces = 0
    with open(path, "w") as f:
        f.write("# graphik_tpu mesh export\n")
        for name, verts, faces in groups:
            if not len(verts):
                continue
            f.write(f"o {name}\n")
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for face in faces:
                a, b, c = (int(x) + 1 + n_total for x in face)
                f.write(f"f {a} {b} {c}\n")
            n_total += len(verts)
            n_faces += len(faces)
    return n_total, n_faces


def export_scene_obj(ps, q, path, link_radius=0.025, T_goal=None,
                     axis_scale=0.12, link_meshes=None):
    """Write the solved scene as a Wavefront OBJ triangle mesh.

    The reference renders URDF meshes in a pyrender window
    (urdf_visualization.py:158-177); the meshes are stripped from its
    checkout, so the faithful equivalent here is generated link geometry:
    link cylinders at configuration q, obstacle spheres, and (optionally)
    goal-frame axis rods, grouped per object so viewers can color them.
    Returns (n_vertices, n_faces).

    link_meshes: optional {link_index: mesh_path | (mesh_path, T_local)}
    - per-link .obj/.stl files (load_mesh) posed in that link's world
    frame (optionally offset by the 4x4 T_local), replacing the generated
    cylinder for that link. This is the mesh-visualization analogue of
    the reference's URDF-mesh scene (urdf_visualization.py:9-60).
    """
    tpl = ps.template
    from graphik_tpu.robots import kinematics as _kin

    T_all = np.asarray(_kin.all_poses(tpl, np.asarray(q, dtype=float)))
    link_meshes = link_meshes or {}
    groups = []
    for i in range(1, tpl.n + 1):
        par = int(tpl.parents[i])
        if i in link_meshes:
            spec = link_meshes[i]
            mesh_path, T_local = spec if isinstance(spec, tuple) else (
                spec, np.eye(4)
            )
            mv, mf = load_mesh(mesh_path)
            Tw = T_all[i] @ np.asarray(T_local, float)
            mv = mv @ Tw[:3, :3].T + Tw[:3, 3]
            groups.append((f"link_{par}_{i}_mesh", mv, mf))
            continue
        groups.append((f"link_{par}_{i}", *_cylinder_mesh(
            T_all[par, :3, 3], T_all[i, :3, 3], link_radius
        )))
    for k, (center, radius) in enumerate(ps.obstacles):
        groups.append((f"obstacle_{k}", *_sphere_mesh(center, radius)))
    if T_goal is not None:
        Tg = np.asarray(T_goal)
        if Tg.ndim == 2:
            Tg = Tg[None]
        for g, T in enumerate(Tg):
            for a in range(3):
                tip = T[:3, 3] + axis_scale * T[:3, a]
                groups.append((f"goal_{g}_axis_{a}", *_cylinder_mesh(
                    T[:3, 3], tip, link_radius * 0.35, n_theta=8
                )))
    n_total = 0
    n_faces = 0
    with open(path, "w") as f:
        f.write("# graphik_tpu scene export\n")
        for name, verts, faces in groups:
            if not len(verts):
                continue
            f.write(f"o {name}\n")
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for face in faces:
                a, b, c = (int(x) + 1 + n_total for x in face)
                f.write(f"f {a} {b} {c}\n")
            n_total += len(verts)
            n_faces += len(faces)
    return n_total, n_faces
